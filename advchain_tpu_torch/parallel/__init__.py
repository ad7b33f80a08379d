"""Training steps on one GPU; the multi-device mesh is not ported yet."""

from advchain_tpu_torch.parallel.train import (TrainState,
                                               make_adversarial_train_step,
                                               make_supervised_train_step)

__all__ = ["TrainState", "make_adversarial_train_step",
           "make_supervised_train_step"]
