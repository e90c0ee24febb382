"""The genetic search's checkpoint state: the `__genetics__` entry of a
sweep checkpoint, in the reference package's bytes.

The reference stores `pickle.dumps(list of GeneticStrategy)`, one per
lane, and reads it back with `pickle.loads`. Its `GeneticStrategy` and
the port's (fault/strategies.py) hold the same dataclass fields and the
same state (`times`, `_rng`, the permuted `prune_weights`), so one
pickle serves both packages once the class name is translated:

- `dumps` writes the port's objects under the reference's global
  (`rram_caffe_simulation_tpu.fault.strategies GeneticStrategy`)
  without importing the reference: a pure-Python pickler whose
  `save_global` emits that name for the port's class. The reference's
  plain `pickle.loads` reads the bytes.
- `loads` maps that name to the port's class and allows only the names
  numpy's arrays and `RandomState` pickle through; any other global
  (a function, another class) is refused by name, so a checkpoint
  cannot make the reader run arbitrary code.
"""
from __future__ import annotations

import io
import pickle
from typing import List

from .strategies import GeneticStrategy

REFERENCE_GLOBAL = ("rram_caffe_simulation_tpu.fault.strategies",
                    "GeneticStrategy")
PROTOCOL = 4      # the reference's pickle.DEFAULT_PROTOCOL on Python 3.12
# the globals numpy's ndarray, scalars, dtypes and RandomState pickle
# through (numpy 1.x keeps multiarray under numpy.core, 2.x numpy._core)
NUMPY_GLOBALS = frozenset(
    [(mod, name) for mod in ("numpy.core.multiarray",
                             "numpy._core.multiarray")
     for name in ("_reconstruct", "scalar")]
    + [("numpy", "ndarray"), ("numpy", "dtype"),
       ("numpy.random._pickle", "__randomstate_ctor"),
       ("numpy.random._pickle", "__bit_generator_ctor"),
       ("numpy.random._mt19937", "MT19937")])


class _Pickler(pickle._Pickler):
    """The pure-Python pickler with the port's GeneticStrategy written
    under the reference's module and name."""

    def save_global(self, obj, name=None):
        if obj is not GeneticStrategy:
            return super().save_global(obj, name)
        self.save(REFERENCE_GLOBAL[0])
        self.save(REFERENCE_GLOBAL[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    """Reads the reference's class as the port's; numpy's names only."""

    def find_class(self, module, name):
        if (module, name) == REFERENCE_GLOBAL:
            return GeneticStrategy
        if (module, name) in NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"genetic state names the global {module}.{name}, which it may "
            "not load (allowed: the reference's GeneticStrategy and numpy's "
            "array and RandomState names)")


def dumps(genetics: List[GeneticStrategy]) -> bytes:
    """The `__genetics__` bytes of one GeneticStrategy a lane."""
    buf = io.BytesIO()
    _Pickler(buf, protocol=PROTOCOL).dump(list(genetics))
    return buf.getvalue()


def loads(data) -> List[GeneticStrategy]:
    """The lanes' GeneticStrategy objects from `__genetics__` bytes (a
    uint8 array or bytes) of either package."""
    out = _Unpickler(io.BytesIO(bytes(bytearray(data)))).load()
    if not isinstance(out, list) or not all(
            isinstance(g, GeneticStrategy) for g in out):
        raise pickle.UnpicklingError(
            "genetic state is not a list of GeneticStrategy")
    return out
