"""Optimizers with the JAX package's arithmetic (``repro/optim``)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    adam, adamw, sgd, rowwise_adagrad, apply_updates, linear_decay,
    OptState, Optimizer,
)
