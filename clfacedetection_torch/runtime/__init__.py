from .batch import BatchedPyramidDetector, MultiCascadeBatchedDetector
from .program import Handle, Program

__all__ = ["BatchedPyramidDetector", "MultiCascadeBatchedDetector",
           "Handle", "Program"]
