from .manager import (CheckpointManager, latest_step, restore_checkpoint,
                      save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
