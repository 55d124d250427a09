from repro_torch.checkpoint.ckpt import (CheckpointShapeError,
                                        CorruptCheckpointError, is_jax_layout,
                                        latest_step, read_tree, restore, save,
                                        save_async)

__all__ = ["CheckpointShapeError", "CorruptCheckpointError", "is_jax_layout",
           "latest_step", "read_tree", "restore", "save", "save_async"]
