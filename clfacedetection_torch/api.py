"""Public detection API (torch port).

Port of ``clfacedetection_tpu/api.py``: ``CascadeClassifier`` (the
``cvHaarDetectObjects`` parameter surface) and ``detect_objects`` (the
reference's ``clodDetectObjects``, clod.h:61-81).  Detectors are built
per (mode, frame shape, parameters) and cached.

Both pyramid modes run every cascade of the zoo: scale-image
(``PyramidDetector``, with every ``clod_flags`` strategy) and
scale-cascade (``ScaleCascadeDetector``, with Canny pruning), each with
the ROC overload (``detect_multi_scale3``); ``CV_HAAR_FIND_BIGGEST_OBJECT``
runs the scale-cascade search on the card and the numpy golden path on
the CPU, and ``detect_objects(use_gpu=False)`` the golden path.  The
entry points run on the card unless given ``device="cpu"``, and raise
without one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .detect.detector import (DetectionResult, ScaleCascadeDetector,
                              default_device)
from .detect.grouping import group_rectangles_levels
from .detect.pyramid import PyramidDetector
from .detect.reference_impl import detect_multi_scale_reference
from .models.spec import CascadeSpec
from .models.zoo import load_cascade
from .ops.integral import bgr_to_gray, bgra_to_gray

__all__ = ["CascadeClassifier", "detect_objects", "WeightedRect",
           "CLOD_PRECOMPUTE_FEATURES", "CLOD_BLOCK_IMPLEMENTATION",
           "CLOD_PER_STAGE_ITERATIONS", "CV_HAAR_DO_CANNY_PRUNING",
           "CV_HAAR_SCALE_IMAGE", "CV_HAAR_FIND_BIGGEST_OBJECT",
           "CV_HAAR_DO_ROUGH_SEARCH"]

# clod_flags (clod.h:17-21; the reference defines them as 2<<n)
CLOD_PRECOMPUTE_FEATURES = 2 << 0
CLOD_BLOCK_IMPLEMENTATION = 2 << 1
CLOD_PER_STAGE_ITERATIONS = 2 << 2

# OpenCV haar flags (tempcv.hpp:127-130)
CV_HAAR_DO_CANNY_PRUNING = 1
CV_HAAR_SCALE_IMAGE = 2
CV_HAAR_FIND_BIGGEST_OBJECT = 4
CV_HAAR_DO_ROUGH_SEARCH = 8


@dataclasses.dataclass(frozen=True)
class WeightedRect:
    """CLODWeightedRect (clod.h:39-47)."""

    x: int
    y: int
    width: int
    height: int
    weight: int  # neighbour count after grouping


def _to_gray(image) -> np.ndarray:
    image = np.asarray(image)
    if image.ndim == 3 and image.shape[-1] == 3:
        return bgr_to_gray(torch.from_numpy(image)).numpy()
    if image.ndim == 3 and image.shape[-1] == 4:
        return bgra_to_gray(torch.from_numpy(image)).numpy()
    if image.ndim == 2:
        return image.astype(np.uint8, copy=False)
    raise ValueError(f"expected (H, W) gray, (H, W, 3) BGR or (H, W, 4) "
                     f"BGRA, got {image.shape}")


class CascadeClassifier:
    """OpenCV-compatible multi-scale detector over one cascade model, on
    ``device`` (the card unless ``"cpu"``).

    >>> clf = CascadeClassifier("haarcascade_frontalface_alt")
    >>> boxes = clf.detect_multi_scale(frame, scale_factor=1.1,
    ...                                min_neighbors=3, min_size=(40, 40))

    ``mode`` selects the pyramid, as the reference's CV_HAAR_SCALE_IMAGE
    flag does (tempcv.cpp:1257):

    * ``"scale_image"`` (default): the frame downscaled per level, a fixed
      window; the packed canvas and its kernels (``PyramidDetector``);
    * ``"scale_cascade"``: a fixed frame, the features rescaled per scale
      (``ScaleCascadeDetector``); the mode the reference demo runs
      (main.cpp:145, flags=0).
    """

    def __init__(self, cascade: Union[str, CascadeSpec],
                 dtype: torch.dtype = torch.float32, device=None,
                 mode: str = "scale_image"):
        self.spec = (cascade if isinstance(cascade, CascadeSpec)
                     else load_cascade(cascade))
        self.dtype = dtype
        self.device = device
        if mode not in ("scale_image", "scale_cascade"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self._detectors: Dict[tuple, object] = {}

    @property
    def original_window_size(self) -> Tuple[int, int]:
        return (self.spec.window_w, self.spec.window_h)

    def empty(self) -> bool:
        return self.spec.n_stages == 0

    def _detector(self, shape, scale_factor, min_size, max_size,
                  mode=None, **knobs):
        mode = mode or self.mode
        key = (mode, shape, float(scale_factor), tuple(min_size),
               tuple(max_size) if max_size else None,
               tuple(sorted(knobs.items())))
        det = self._detectors.get(key)
        if det is None:
            cls = (PyramidDetector if mode == "scale_image"
                   else ScaleCascadeDetector)
            det = cls(self.spec, shape, scale_factor=scale_factor,
                      min_size=tuple(min_size),
                      max_size=tuple(max_size) if max_size else None,
                      dtype=self.dtype, device=self.device, **knobs)
            self._detectors[key] = det
        return det

    def detect_multi_scale(self, image, scale_factor: float = 1.1,
                           min_neighbors: int = 3, flags: int = 0,
                           min_size: Tuple[int, int] = (0, 0),
                           max_size: Optional[Tuple[int, int]] = None,
                           **knobs) -> np.ndarray:
        """Detect objects; returns int32 boxes [n, 4] as (x, y, w, h)."""
        return self.detect_multi_scale_full(
            image, scale_factor, min_neighbors, flags, min_size, max_size,
            **knobs).boxes

    def detect_multi_scale2(self, image, scale_factor: float = 1.1,
                            min_neighbors: int = 3, flags: int = 0,
                            min_size: Tuple[int, int] = (0, 0),
                            max_size: Optional[Tuple[int, int]] = None,
                            **knobs):
        """(boxes, neighbour counts), as cv2's detectMultiScale2."""
        res = self.detect_multi_scale_full(
            image, scale_factor, min_neighbors, flags, min_size, max_size,
            **knobs)
        return res.boxes, res.neighbors

    def detect_multi_scale3(self, image, scale_factor: float = 1.1,
                            min_neighbors: int = 3,
                            min_size: Tuple[int, int] = (0, 0),
                            max_size: Optional[Tuple[int, int]] = None,
                            **knobs):
        """The ROC overload (cv2's detectMultiScale3 with
        outputRejectLevels): (boxes, reject_levels, level_weights).  With
        ``min_neighbors`` 0 every window that exits within 4 stages of the
        end (or that a stage tree accepts), with its exit stage and stage
        sum; else those grouped by ``group_rectangles_levels``
        (JAX ``api.py:156-189``).

        Only scale-image mode has per-window levels (tempcv.cpp:1084-1095).
        The reference's scale-cascade invoker never fills them
        (tempcv.cpp:1155-1158), so its levels grouping sees empty levels:
        no boxes for ``min_neighbors > 0``, and the candidates with empty
        level arrays for 0 (tempcv.cpp:1466-1469), as here."""
        gray = _to_gray(image)
        if self.mode != "scale_image":
            det = self._detector(gray.shape, scale_factor, min_size,
                                 max_size, **knobs)
            boxes, _ = det.candidates(gray)
            levels = np.zeros(0, np.int32)
            weights = np.zeros(0, np.float64)
        else:
            det = self._detector(gray.shape, scale_factor, min_size,
                                 max_size, output_levels=True, **knobs)
            boxes, levels, weights, _ = det.candidates_with_levels(gray)
        if min_neighbors != 0:
            return group_rectangles_levels(boxes, levels, weights,
                                           min_neighbors, eps=0.2)
        return boxes, levels, weights

    def detect_multi_scale_full(self, image, scale_factor: float = 1.1,
                                min_neighbors: int = 3, flags: int = 0,
                                min_size: Tuple[int, int] = (0, 0),
                                max_size: Optional[Tuple[int, int]] = None,
                                **knobs) -> DetectionResult:
        gray = _to_gray(image)
        if flags & CV_HAAR_FIND_BIGGEST_OBJECT:
            # the ROI-shrink loop is sequential host logic in the reference
            # too (tempcv.cpp:1349-1454): on the card each scale's windows
            # run on the device; on the CPU the golden path runs, as the
            # JAX package does off the TPU (api.py:199-222)
            rough = bool(flags & CV_HAAR_DO_ROUGH_SEARCH)
            device = torch.device(self.device) if self.device is not None \
                else default_device()
            if device.type == "cpu":
                boxes = detect_multi_scale_reference(
                    gray, self.spec, scale_factor=scale_factor,
                    min_neighbors=min_neighbors, min_size=tuple(min_size),
                    find_biggest_object=True, rough_search=rough)
            else:
                det = self._detector(gray.shape, scale_factor, (0, 0),
                                     max_size, mode="scale_cascade", **knobs)
                boxes = det.find_biggest_object(
                    gray, min_neighbors=min_neighbors,
                    min_size=tuple(min_size), rough_search=rough)
            return DetectionResult(
                boxes=boxes, neighbors=np.ones(len(boxes), np.int32),
                candidates=boxes, survivor_overflow=False)
        mode = "scale_image" if flags & CV_HAAR_SCALE_IMAGE else self.mode
        if flags & CV_HAAR_DO_CANNY_PRUNING and mode == "scale_cascade":
            # Canny pruning exists in the scale-cascade detector only
            # (tempcv.cpp:1337-1342); scale-image mode drops the flag, as
            # the JAX package does (api.py:227-230)
            knobs = dict(knobs, do_canny_pruning=True)
        det = self._detector(gray.shape, scale_factor, min_size, max_size,
                             mode=mode, **knobs)
        return det.detect(gray, min_neighbors=min_neighbors)


def detect_objects(image, cascade: Union[str, CascadeSpec],
                   min_window_size: Optional[Tuple[int, int]] = None,
                   max_window_size: Optional[Tuple[int, int]] = None,
                   min_neighbors: int = 3,
                   flags: int = (CLOD_PRECOMPUTE_FEATURES
                                 | CLOD_PER_STAGE_ITERATIONS),
                   scale_factor: float = 1.1, use_gpu: bool = True,
                   device=None):
    """clodDetectObjects-shaped entry point (clod.h:61-81); returns a list
    of :class:`WeightedRect`.  The ``clod_flags`` strategy bits map as in
    the JAX package (``clfacedetection_tpu/api.py:282-287``):

    - ``CLOD_PER_STAGE_ITERATIONS`` -> ``strategy="per_stage"``, front 4:
      tail2's in-kernel cascade walk where the cascade allows it, the v1
      tail otherwise;
    - ``CLOD_BLOCK_IMPLEMENTATION`` (or ``CLOD_PRECOMPUTE_FEATURES``
      alone) -> ``strategy="block"``, front 2: the v1 tail, every node's
      value for every survivor;
    - neither bit -> ``strategy="direct"``, front 2: every node's value
      from one stencil matrix product (JAX's XLA tail).

    ``use_gpu=False`` runs the numpy golden path in scale-cascade mode,
    the counterpart of the reference's ``use_opencl=false`` CPU fallback
    and of the JAX package's ``use_tpu=False`` (``api.py:273-281``); its
    boxes carry weight 0."""
    spec = cascade if isinstance(cascade, CascadeSpec) else \
        load_cascade(cascade)
    min_size = tuple(min_window_size) if min_window_size else (0, 0)
    if not use_gpu:
        boxes = detect_multi_scale_reference(
            _to_gray(image), spec, scale_factor=scale_factor,
            min_neighbors=min_neighbors, min_size=min_size,
            max_size=max_window_size)
        return [WeightedRect(int(x), int(y), int(w), int(h), 0)
                for x, y, w, h in boxes]
    if flags & CLOD_PER_STAGE_ITERATIONS:
        strategy, front = "per_stage", 4
    elif flags & (CLOD_BLOCK_IMPLEMENTATION | CLOD_PRECOMPUTE_FEATURES):
        strategy, front = "block", 2
    else:
        strategy, front = "direct", 2
    clf = CascadeClassifier(spec, device=device)
    res = clf.detect_multi_scale_full(
        image, scale_factor=scale_factor, min_neighbors=min_neighbors,
        min_size=min_size, max_size=max_window_size, front_stages=front,
        strategy=strategy)
    return [WeightedRect(int(x), int(y), int(w), int(h), int(n))
            for (x, y, w, h), n in zip(res.boxes, res.neighbors)]
