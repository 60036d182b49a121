"""Training (counterpart of ``repro.training``): data, AdamW, the train
step and checkpoints; ``python -m repro_torch.launch.train`` drives them."""
from repro_torch.training.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.training.data import DataConfig, batch_at, embedding_batch_at  # noqa: F401
from repro_torch.training.optimizer import (AdamWConfig, OptState,  # noqa: F401
                                            adamw_update, init_opt_state, schedule)
from repro_torch.training.train_step import (lm_loss, make_eval_step,  # noqa: F401
                                             make_train_step, value_and_grad)
