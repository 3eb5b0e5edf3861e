"""Data efficiency pipeline (reference: deepspeed/runtime/data_pipeline/)."""

from .curriculum_scheduler import CurriculumScheduler
