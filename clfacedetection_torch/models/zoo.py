"""Named access to the bundled Haar cascades.

The compiled ``.npz`` artifacts live in the JAX package's data directory
(``clfacedetection_tpu/models/artifacts``).  They are read here as data
files, by path: importing the JAX package would import ``jax``.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

from .spec import CascadeSpec

__all__ = ["artifact_dir", "load_cascade"]


def artifact_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "clfacedetection_tpu", "models", "artifacts")


@functools.lru_cache(maxsize=None)
def load_cascade(name: str, path: Optional[str] = None) -> CascadeSpec:
    """Load a cascade by name (``haarcascade_frontalface_alt``) or by an
    explicit ``.npz`` path."""
    if path is None:
        if name.endswith(".npz"):
            path = name
        else:
            path = os.path.join(artifact_dir(), name + ".npz")
    if not path.endswith(".npz"):
        raise ValueError(f"only .npz cascade artifacts are supported, got "
                         f"{path!r}")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"cascade {name!r} not found at {path!r}")
    return CascadeSpec.load(path)
