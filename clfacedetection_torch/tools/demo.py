"""Demo and timing app: the counterpart of the reference's ``main.cpp``.

    python -m clfacedetection_torch.tools.demo [--cascade NAME_OR_XML]
        [--image PATH] [--min-size 40] [--min-neighbors 0]
        [--skip-baseline] [--out-dir DIR] [--device cuda|cpu]

The reference loads ``haarcascade_frontalface_default`` and a 640x480
frame, then times the OpenCV baseline against its own detector, drawing
each result (main.cpp:19-187).  Here, on the card unless ``--device
cpu``:

* baseline      = the numpy golden path (OpenCV 2.4's semantics);
* scale_image   = ``CascadeClassifier`` over the packed pyramid;
* scale_cascade = ``CascadeClassifier(mode="scale_cascade")``, the mode
  the reference demo runs (flags=0);
* batched       = ``BatchedPyramidDetector`` at batch 8, the webcam
  loop's frames/s (main.cpp:104-125);
* multi-cascade = ``MultiCascadeBatchedDetector`` of the cascade and
  ``haarcascade_profileface`` in one program.

Each result is written as an annotated PPM file and printed with its
ms/frame and boxes; a mode's time is ``time_torch``'s, the mean of 5
calls after one warm-up (CUDA events on the card).  ``--cascade`` takes a zoo name or a path to an
OpenCV ``.xml`` (or ``.npz``) cascade.  ``--image`` reads a photo
through ``cv2`` and raises a clear error where cv2 does not import;
without it the demo runs on a synthetic 640x480 scene with two faces.
A failing mode raises: the demo exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, List, Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(_ROOT, "demo_out")
BATCH = 8
REPS = 5
MULTI = ("haarcascade_frontalface_default", "haarcascade_profileface")


def draw_boxes(gray: np.ndarray, boxes, path: str) -> str:
    """Write ``gray`` with ``boxes`` drawn in red as a binary PPM."""
    rgb = np.stack([gray] * 3, axis=-1)
    for x, y, w, h in np.asarray(boxes).reshape(-1, 4):
        x2, y2 = min(x + w, rgb.shape[1] - 1), min(y + h, rgb.shape[0] - 1)
        rgb[y, x:x2] = rgb[y2, x:x2] = (255, 32, 32)
        rgb[y:y2, x] = rgb[y:y2, x2] = (255, 32, 32)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]))
        f.write(rgb.astype(np.uint8).tobytes())
    return path


def read_image(path: str) -> np.ndarray:
    """A photo as 640x480 gray (main.cpp:47-51), through cv2."""
    try:
        import cv2  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            f"--image needs OpenCV's cv2 to decode {path!r}, and cv2 does "
            f"not import here ({e}); run without --image for the "
            f"synthetic scene") from e
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise RuntimeError(f"cv2 could not read {path!r}")
    return cv2.resize(img, (640, 480))


def main(argv: Optional[List[str]] = None,
         log: Callable[[str], None] = print) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cascade", default="haarcascade_frontalface_default",
                    help="zoo name, or a path to a .xml/.npz cascade")
    ap.add_argument("--image", default=None, help="path to a photo")
    ap.add_argument("--min-size", type=int, default=40)
    ap.add_argument("--min-neighbors", type=int, default=0,
                    help="the reference demo uses 0 (main.cpp:165)")
    ap.add_argument("--skip-baseline", action="store_true",
                    help="skip the (slow) numpy golden baseline")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from .. import CascadeClassifier
    from ..models import load_cascade
    from ..runtime import (BatchedPyramidDetector,
                           MultiCascadeBatchedDetector)
    from ..utils import ElapseTime, synth_scene, time_torch

    img = (read_image(args.image) if args.image else
           synth_scene((480, 640), faces=[(200, 200, 60), (280, 460, 90)]))
    os.makedirs(args.out_dir, exist_ok=True)
    spec = load_cascade(args.cascade)
    dev = args.device
    mn, msz = args.min_neighbors, (args.min_size, args.min_size)
    t = ElapseTime()
    out = {"cascade": spec.name, "device": dev, "shape": list(img.shape),
           "boxes": {}, "ms": {}}

    if not args.skip_baseline:
        from ..detect.reference_impl import detect_multi_scale_reference
        t.start()
        out["boxes"]["baseline"] = detect_multi_scale_reference(
            img, spec, min_neighbors=mn, min_size=msz)
        out["ms"]["baseline"] = t.get()
        log(f"golden baseline (OpenCV 2.4 semantics, numpy): "
            f"{out['ms']['baseline']:9.2f} ms")

    for mode in ("scale_image", "scale_cascade"):
        clf = CascadeClassifier(spec, mode=mode, device=dev)
        out["ms"][mode], boxes = time_torch(
            lambda: clf.detect_multi_scale(img, min_neighbors=mn,
                                           min_size=msz),
            iters=REPS, warmup=1, device=dev)
        out["boxes"][mode] = boxes
        log(f"{dev} {mode:14s}: {out['ms'][mode]:9.2f} ms   "
            f"{len(boxes)} boxes")

    out["files"] = {}
    for name, boxes in out["boxes"].items():
        p = draw_boxes(img, boxes, os.path.join(args.out_dir,
                                                f"{name}.ppm"))
        out["files"][name] = p
        log(f"  {name:14s} {len(boxes):3d} boxes -> {p}")

    if "baseline" in out["boxes"]:
        o = {tuple(b) for b in np.asarray(out["boxes"]["baseline"]).tolist()}
        sc = {tuple(b) for b in
              np.asarray(out["boxes"]["scale_cascade"]).tolist()}
        out["scale_cascade_equals_baseline"] = o == sc
        log("scale_cascade box-for-box vs baseline: " +
            ("MATCH" if o == sc else f"{len(o ^ sc)} differ (float32)"))

    # the webcam loop's analog: batched frames/s (main.cpp:104-125)
    frames = np.stack([img] * BATCH)
    det = BatchedPyramidDetector(spec, img.shape, BATCH, min_size=msz,
                                 device=dev)
    ms, res = time_torch(det.detect, frames, mn, iters=REPS, warmup=1,
                         device=dev)
    ms /= BATCH
    out["batched"] = {"ms_per_frame": ms, "fps": 1000 / ms,
                      "boxes": [len(r.boxes) for r in res]}
    log(f"batched video ({img.shape[1]}x{img.shape[0]}, batch {BATCH}): "
        f"{ms:.2f} ms/frame = {1000 / ms:.1f} fps")

    # BASELINE config 5's analog: several cascades over one batch in one
    # program (the reference times one cvHaarDetectObjects call each)
    specs = [spec if n == spec.name else load_cascade(n) for n in MULTI]
    multi = MultiCascadeBatchedDetector(specs, img.shape, BATCH,
                                        min_size=msz, device=dev)
    ms, mres = time_torch(multi.detect, frames, mn, iters=REPS, warmup=1,
                          device=dev)
    ms /= BATCH
    counts = {s.name: len(mres[k][0].boxes) for k, s in enumerate(specs)}
    out["multi"] = {"ms_per_frame": ms, "fps": 1000 / ms, "boxes": counts}
    log(f"multi-cascade fused (x{len(specs)}, batch {BATCH}): "
        f"{ms:.2f} ms/frame = {1000 / ms:.1f} fps   " +
        ", ".join(f"{n}={c}" for n, c in counts.items()))
    log("row-strip sharded: not run (multi-GPU sharding is not in this "
        "package yet)")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
