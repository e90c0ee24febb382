from .sweep import GroupPrefetcher, SweepRunner

__all__ = ["GroupPrefetcher", "SweepRunner"]
