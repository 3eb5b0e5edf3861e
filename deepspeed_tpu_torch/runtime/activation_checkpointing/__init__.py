from .checkpointing import (  # noqa: F401
    checkpoint,
    checkpoint_wrapped,
    configure,
    get_config,
    get_rng_tracker,
    is_configured,
    model_overrides,
    reset,
    set_config,
    summarize,
)
