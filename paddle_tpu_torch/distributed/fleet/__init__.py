from .engine import ParallelTrainStep

__all__ = ["ParallelTrainStep"]
