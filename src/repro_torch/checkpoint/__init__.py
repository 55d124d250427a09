from repro_torch.checkpoint.ckpt import (CorruptCheckpointError, latest_step,
                                        restore, save, save_async)

__all__ = ["CorruptCheckpointError", "latest_step", "restore", "save",
           "save_async"]
