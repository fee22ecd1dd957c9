"""LM training: the step function and the fault-tolerant loop (the port's
twin of ``repro.train``)."""

from repro_torch.train.trainer import (  # noqa: F401
    TrainConfig, Trainer, make_train_step, train_state_init,
    train_state_specs)
