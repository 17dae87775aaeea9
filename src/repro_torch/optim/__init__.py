from .optimizers import (  # noqa: F401
    Optimizer,
    adagrad,
    adam,
    apply_updates,
    get,
    momentum,
    sgd,
    yogi,
)
