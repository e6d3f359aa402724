"""Numerical ops: encodings, MLPs, losses, optimizers, trainer.

This is the JAX equivalent of the reference's tiny-cuda-nn layer
(SURVEY.md §2.1), in plain JAX that XLA compiles for the device.
"""

from .encodings import create_encoding  # noqa: F401
from .grid_encoding import GridEncoding  # noqa: F401
from .losses import create_loss, loss_and_gradient  # noqa: F401
from .mlp import MLP, NetworkWithInputEncoding  # noqa: F401
from .optimizers import create_optimizer  # noqa: F401
