"""Public detection API (torch port).

Port of ``clfacedetection_tpu/api.py`` in scale-image mode:
``CascadeClassifier`` (the ``cvHaarDetectObjects`` parameter surface) and
``detect_objects`` (the reference's ``clodDetectObjects``, clod.h:61-81).
Detectors are built per (frame shape, parameters) and cached.

Every cascade of the zoo runs, with every ``clod_flags`` strategy and
the ROC overload (``detect_multi_scale3``).  The entry points run on the
card unless given ``device="cpu"``, and raise without one.  Not ported
yet (ROADMAP Queue 1): scale-cascade mode with its Canny pruning,
find-biggest-object and the numpy golden path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .detect.detector import DetectionResult
from .detect.grouping import group_rectangles_levels
from .detect.pyramid import PyramidDetector
from .models.spec import CascadeSpec
from .models.zoo import load_cascade
from .ops.integral import bgr_to_gray, bgra_to_gray

__all__ = ["CascadeClassifier", "detect_objects", "WeightedRect",
           "CLOD_PRECOMPUTE_FEATURES", "CLOD_BLOCK_IMPLEMENTATION",
           "CLOD_PER_STAGE_ITERATIONS"]

# clod_flags (clod.h:17-21; the reference defines them as 2<<n)
CLOD_PRECOMPUTE_FEATURES = 2 << 0
CLOD_BLOCK_IMPLEMENTATION = 2 << 1
CLOD_PER_STAGE_ITERATIONS = 2 << 2

# OpenCV haar flags (tempcv.hpp:127-130)
CV_HAAR_DO_CANNY_PRUNING = 1
CV_HAAR_FIND_BIGGEST_OBJECT = 4


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
    """OpenCV-compatible multi-scale detector over one cascade model, in
    scale-image mode, on ``device`` (the card unless ``"cpu"``).

    >>> clf = CascadeClassifier("haarcascade_frontalface_alt")
    >>> boxes = clf.detect_multi_scale(frame, scale_factor=1.1,
    ...                                min_neighbors=3, min_size=(40, 40))
    """

    def __init__(self, cascade: Union[str, CascadeSpec],
                 dtype: torch.dtype = torch.float32, device=None):
        self.spec = (cascade if isinstance(cascade, CascadeSpec)
                     else load_cascade(cascade))
        self.dtype = dtype
        self.device = device
        self._detectors: Dict[tuple, PyramidDetector] = {}

    @property
    def original_window_size(self) -> Tuple[int, int]:
        return (self.spec.window_w, self.spec.window_h)

    def empty(self) -> bool:
        return self.spec.n_stages == 0

    def _detector(self, shape, scale_factor, min_size, max_size, **knobs):
        key = (shape, float(scale_factor), tuple(min_size),
               tuple(max_size) if max_size else None,
               tuple(sorted(knobs.items())))
        det = self._detectors.get(key)
        if det is None:
            det = PyramidDetector(
                self.spec, shape, scale_factor=scale_factor,
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
        (JAX ``api.py:156-189``, scale-image mode)."""
        gray = _to_gray(image)
        det = self._detector(gray.shape, scale_factor, min_size, max_size,
                             output_levels=True, **knobs)
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
        # CV_HAAR_DO_CANNY_PRUNING acts in scale-cascade mode only
        # (tempcv.cpp:1337-1342), so scale-image mode drops it, as the
        # JAX package does (api.py:227-230)
        if flags & CV_HAAR_FIND_BIGGEST_OBJECT:
            raise NotImplementedError(
                "find-biggest-object is not ported yet (ROADMAP Queue 1)")
        gray = _to_gray(image)
        det = self._detector(gray.shape, scale_factor, min_size, max_size,
                             **knobs)
        return det.detect(gray, min_neighbors=min_neighbors)


def detect_objects(image, cascade: Union[str, CascadeSpec],
                   min_window_size: Optional[Tuple[int, int]] = None,
                   max_window_size: Optional[Tuple[int, int]] = None,
                   min_neighbors: int = 3,
                   flags: int = (CLOD_PRECOMPUTE_FEATURES
                                 | CLOD_PER_STAGE_ITERATIONS),
                   scale_factor: float = 1.1, device=None):
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
      from one stencil matrix product (JAX's XLA tail)."""
    if flags & CLOD_PER_STAGE_ITERATIONS:
        strategy, front = "per_stage", 4
    elif flags & (CLOD_BLOCK_IMPLEMENTATION | CLOD_PRECOMPUTE_FEATURES):
        strategy, front = "block", 2
    else:
        strategy, front = "direct", 2
    spec = cascade if isinstance(cascade, CascadeSpec) else \
        load_cascade(cascade)
    clf = CascadeClassifier(spec, device=device)
    res = clf.detect_multi_scale_full(
        image, scale_factor=scale_factor, min_neighbors=min_neighbors,
        min_size=tuple(min_window_size) if min_window_size else (0, 0),
        max_size=max_window_size, front_stages=front, strategy=strategy)
    return [WeightedRect(int(x), int(y), int(w), int(h), int(n))
            for (x, y, w, h), n in zip(res.boxes, res.neighbors)]
