"""clfacedetection_torch — the PyTorch/CUDA port of clfacedetection_tpu.

Viola-Jones object detection with OpenCV 2.4's semantics in both pyramid
modes: cascade loading (the zoo's ``.npz`` artifacts, OpenCV's old- and
new-format XML files and the haartraining text directories, by name
through ``$CLFD_CASCADE_DIR`` or by path), integral images, the scale-image detector (a
packed resize pyramid and five hand-written CUDA kernels for Hopper:
dense front, ordered compaction, the tail2 cascade walk, the v1 all-nodes
tail and its votes and stage sums, behind plain PyTorch twins that run on
the CPU), the scale-cascade detector (plain PyTorch over the scales, with
Canny pruning and find-biggest-object; its compactions run the
compaction kernel), and the numpy golden path.  On the card each
float32 path runs as a captured CUDA graph (``runtime/program.py``), one
per batch size or per scale loop at its current cap.  A sixth kernel, the
op-chain microbenchmark, serves the tool ``tools/mb_vpu3.py``.  The
host's grouping runs a C++ twin of the numpy specification, built with
``g++`` at first use beside a C++ window oracle (``native/``);
``tools/demo.py`` is the reference demo's counterpart.  The
multi-device layer (``runtime/mesh.py``, ``parallel/``) shards batches,
a frame's canvas rows or scale-cascade mode's scales over a mesh of
devices driven from one process.  Imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from .api import CascadeClassifier, WeightedRect, detect_objects
from .detect import DetectionResult, PyramidDetector, ScaleCascadeDetector
from .models import CASCADE_NAMES, CascadeSpec, load_cascade
from .runtime import BatchedPyramidDetector, MultiCascadeBatchedDetector

__all__ = [
    "CascadeClassifier", "WeightedRect", "detect_objects",
    "DetectionResult", "PyramidDetector", "ScaleCascadeDetector",
    "BatchedPyramidDetector", "MultiCascadeBatchedDetector",
    "CascadeSpec", "load_cascade", "CASCADE_NAMES", "__version__",
]
