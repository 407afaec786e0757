from .ckpt import (CheckpointManager, latest_step, load_checkpoint,
                   save_checkpoint)
from .reshard import gather_state, host_state, reshard_state

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "latest_step", "reshard_state", "host_state", "gather_state"]
