"""repro_torch.training — AdamW, the train step and checkpoints in the JAX
package's format (``repro.training``'s counterparts)."""
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .optim import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    global_norm)
from .trainer import TrainState, init_train_state, make_train_step

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "TrainState", "make_train_step", "init_train_state",
           "save_checkpoint", "restore_checkpoint", "latest_step"]
