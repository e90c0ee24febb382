"""Layer implementations; importing this package registers every ported
layer type."""
from . import common, data_layers, losses, neuron, vision  # noqa: F401
