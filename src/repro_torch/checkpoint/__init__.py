from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    load_checkpoint,
    load_lm,
    restore_scheduler,
    save_checkpoint,
    save_lm,
    save_scheduler,
)
