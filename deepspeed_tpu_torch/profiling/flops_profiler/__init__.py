from .profiler import FlopsProfiler, ProfileResult, get_model_profile, scope_tree

__all__ = ["FlopsProfiler", "ProfileResult", "get_model_profile", "scope_tree"]
