"""Prototxt graph -> Net."""
from .builder import Net, filter_net, state_meets_rule  # noqa: F401
