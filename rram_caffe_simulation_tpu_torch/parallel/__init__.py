from .sweep import SweepRunner

__all__ = ["SweepRunner"]
