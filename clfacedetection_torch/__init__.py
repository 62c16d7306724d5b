"""clfacedetection_torch — the PyTorch/CUDA port of clfacedetection_tpu.

Viola-Jones object detection with OpenCV 2.4's semantics in both pyramid
modes: cascade loading, integral images, the scale-image detector (a
packed resize pyramid and five hand-written CUDA kernels for Hopper:
dense front, ordered compaction, the tail2 cascade walk, the v1 all-nodes
tail and its votes and stage sums, behind plain PyTorch twins that run on
the CPU), the scale-cascade detector (plain PyTorch over the scales, with
Canny pruning and find-biggest-object; its compactions run the
compaction kernel), and the numpy golden path.  A sixth kernel, the
op-chain microbenchmark, serves the tool ``tools/mb_vpu3.py``.  Imports
torch and numpy, never jax.
"""

__version__ = "0.1.0"

from .api import CascadeClassifier, WeightedRect, detect_objects
from .detect import DetectionResult, PyramidDetector, ScaleCascadeDetector
from .models import CascadeSpec, load_cascade
from .runtime import BatchedPyramidDetector

__all__ = [
    "CascadeClassifier", "WeightedRect", "detect_objects",
    "DetectionResult", "PyramidDetector", "ScaleCascadeDetector",
    "BatchedPyramidDetector",
    "CascadeSpec", "load_cascade", "__version__",
]
