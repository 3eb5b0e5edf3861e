from .saver import (  # noqa: F401
    consolidate_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from .zero_to_fp32 import get_fp32_state_dict_from_checkpoint  # noqa: F401
