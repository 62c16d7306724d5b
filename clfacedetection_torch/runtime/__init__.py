from .batch import BatchedPyramidDetector, MultiCascadeBatchedDetector
from .mesh import Mesh, data_parallel_mesh
from .program import Handle, Program

__all__ = ["BatchedPyramidDetector", "MultiCascadeBatchedDetector",
           "Mesh", "data_parallel_mesh", "Handle", "Program"]
