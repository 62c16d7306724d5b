"""Write the decoded pixels of the bundled photograph as a data file.

    python -m clfacedetection_torch.tools.export_photo

Decodes ``clfacedetection_tpu/data/grace_hopper.jpg`` with PIL (the JAX
package's decoder) and writes its RGB pixels, uint8 [600, 512, 3], to
``clfacedetection_torch/data/grace_hopper_rgb.npz`` (``rgb``), which
``utils.photo_gray`` reads: the port needs no JPEG decoder and no PIL.
Run it where PIL is installed; the output is committed.
"""

from __future__ import annotations

import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
JPEG = os.path.join(_ROOT, "clfacedetection_tpu", "data", "grace_hopper.jpg")
NPZ = os.path.join(_ROOT, "clfacedetection_torch", "data",
                   "grace_hopper_rgb.npz")


def main() -> int:
    from PIL import Image
    rgb = np.asarray(Image.open(JPEG).convert("RGB"))
    np.savez_compressed(NPZ, rgb=rgb)
    print(f"{NPZ}: rgb {rgb.shape} {rgb.dtype}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
