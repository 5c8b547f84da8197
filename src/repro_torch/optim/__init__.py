from .sgd import sgd_init, sgd_update
from .adam import adam_init, adam_update
from .api import Optimizer, make_optimizer

__all__ = ["sgd_init", "sgd_update", "adam_init", "adam_update",
           "Optimizer", "make_optimizer"]
