from repro_torch.train.serve import BatchedServer, ServeConfig, SpmvRequest, SpmvServer
from repro_torch.train.trainer import TrainConfig, Trainer, make_loss_fn, make_train_step

__all__ = [
    "TrainConfig",
    "Trainer",
    "make_loss_fn",
    "make_train_step",
    "BatchedServer",
    "ServeConfig",
    "SpmvRequest",
    "SpmvServer",
]
