from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    load_checkpoint,
    restore_scheduler,
    save_checkpoint,
    save_scheduler,
)
