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
compaction kernel), and the numpy golden path.  On the card each path,
in float32 or float64, runs as a captured CUDA graph
(``runtime/program.py``), one per batch size or per scale loop at its
current cap.  A sixth kernel, the
op-chain microbenchmark, serves the tool ``tools/mb_vpu3.py``.  The
host's grouping runs a C++ twin of the numpy specification, built with
``g++`` at first use beside a C++ window oracle (``native/``);
``tools/demo.py`` is the reference demo's counterpart.  The
multi-device layer (``runtime/mesh.py``, ``parallel/``) shards batches,
a frame's canvas rows or scale-cascade mode's scales over a mesh of
devices driven from one process.  ``utils/flops.py`` counts the
pipeline's arithmetic for roofline shares.  Imports torch and numpy,
never jax; the public names below are imported at first use.
"""

__version__ = "0.1.0"

import importlib

# the public names and their modules, imported at first use, so that
# importing a subpackage (e.g. ``clfacedetection_torch.ops``) imports no
# more than it needs: the kernel loader only with a kernel's wrapper
_EXPORTS = {
    "CascadeClassifier": "api", "WeightedRect": "api",
    "detect_objects": "api", "DetectionResult": "detect",
    "PyramidDetector": "detect", "ScaleCascadeDetector": "detect",
    "BatchedPyramidDetector": "runtime",
    "MultiCascadeBatchedDetector": "runtime", "CascadeSpec": "models",
    "load_cascade": "models", "CASCADE_NAMES": "models",
}
_SUBMODULES = ("api", "detect", "kernels", "models", "native", "ops",
               "parallel", "runtime", "tools", "trace", "utils")

__all__ = [
    "CascadeClassifier", "WeightedRect", "detect_objects",
    "DetectionResult", "PyramidDetector", "ScaleCascadeDetector",
    "BatchedPyramidDetector", "MultiCascadeBatchedDetector",
    "CascadeSpec", "load_cascade", "CASCADE_NAMES", "__version__",
]


def __getattr__(name):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(
            f".{_EXPORTS[name]}", __name__), name)
        globals()[name] = value
        return value
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__) | set(_SUBMODULES))
