"""The training step and its update rules."""
from .solver import Solver  # noqa: F401
