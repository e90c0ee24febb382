from .sweep import GroupPrefetcher, SweepRunner, sequential_sweep

__all__ = ["GroupPrefetcher", "SweepRunner", "sequential_sweep"]
