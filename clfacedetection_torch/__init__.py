"""clfacedetection_torch — the PyTorch/CUDA port of clfacedetection_tpu.

Viola-Jones object detection with OpenCV's scale-image semantics: cascade
loading, a packed resize pyramid, integral images, and five hand-written
CUDA kernels for Hopper (dense front, ordered compaction, the tail2
cascade walk, the v1 all-nodes tail and its votes and stage sums) behind
plain PyTorch twins that run on the CPU; a sixth, the op-chain
microbenchmark, serves the tool ``tools/mb_vpu3.py``.  Imports torch and
numpy, never jax.
"""

__version__ = "0.1.0"

from .api import CascadeClassifier, WeightedRect, detect_objects
from .detect import DetectionResult, PyramidDetector
from .models import CascadeSpec, load_cascade
from .runtime import BatchedPyramidDetector

__all__ = [
    "CascadeClassifier", "WeightedRect", "detect_objects",
    "DetectionResult", "PyramidDetector", "BatchedPyramidDetector",
    "CascadeSpec", "load_cascade", "__version__",
]
