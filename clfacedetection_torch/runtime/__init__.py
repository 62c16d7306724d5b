from .batch import BatchedPyramidDetector

__all__ = ["BatchedPyramidDetector"]
