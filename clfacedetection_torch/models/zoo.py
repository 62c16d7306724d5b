"""Named access to the bundled Haar cascades and to users' XML cascades.

A cascade is found by name through, in order:

1. the compiled ``.npz`` artifacts, which live in the JAX package's data
   directory (``clfacedetection_tpu/models/artifacts``) and are read here
   as data files, by path: importing the JAX package would import ``jax``;
2. an XML directory given by ``$CLFD_CASCADE_DIR``;
3. OpenCV's bundled data directory (``cv2.data.haarcascades``, new-format
   XMLs), where ``cv2`` imports.

``load_cascade`` also takes an explicit ``.npz`` or ``.xml`` path.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional

from .haar_xml import parse_haar_xml
from .spec import CascadeSpec

__all__ = ["CASCADE_NAMES", "artifact_dir", "available_cascades",
           "load_cascade"]

CASCADE_NAMES: List[str] = [
    "haarcascade_eye",
    "haarcascade_eye_tree_eyeglasses",
    "haarcascade_frontalface_alt",
    "haarcascade_frontalface_alt2",
    "haarcascade_frontalface_alt_tree",
    "haarcascade_frontalface_default",
    "haarcascade_fullbody",
    "haarcascade_lefteye_2splits",
    "haarcascade_lowerbody",
    "haarcascade_mcs_eyepair_big",
    "haarcascade_mcs_eyepair_small",
    "haarcascade_mcs_lefteye",
    "haarcascade_mcs_mouth",
    "haarcascade_mcs_nose",
    "haarcascade_mcs_righteye",
    "haarcascade_mcs_upperbody",
    "haarcascade_profileface",
    "haarcascade_righteye_2splits",
    "haarcascade_upperbody",
]


def artifact_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "clfacedetection_tpu", "models", "artifacts")


def _xml_search_dirs() -> List[str]:
    dirs = []
    env = os.environ.get("CLFD_CASCADE_DIR")
    if env:
        dirs.append(env)
    try:
        import cv2  # type: ignore
        dirs.append(cv2.data.haarcascades)
    except Exception:
        pass
    return dirs


def available_cascades() -> Dict[str, str]:
    """Map of cascade name -> the path it resolves to."""
    out: Dict[str, str] = {}
    adir = artifact_dir()
    if os.path.isdir(adir):
        for fn in sorted(os.listdir(adir)):
            if fn.endswith(".npz"):
                out.setdefault(fn[:-4], os.path.join(adir, fn))
    for d in _xml_search_dirs():
        if os.path.isdir(d):
            for fn in sorted(os.listdir(d)):
                if fn.endswith(".xml"):
                    out.setdefault(fn[:-4], os.path.join(d, fn))
    return out


@functools.lru_cache(maxsize=None)
def load_cascade(name: str, path: Optional[str] = None) -> CascadeSpec:
    """Load a cascade by name (``haarcascade_frontalface_alt``) or by an
    explicit ``.npz`` or ``.xml`` path."""
    if path is None:
        if name.endswith(".xml") or name.endswith(".npz"):
            path = name
            name = os.path.basename(name)[:-4]
        else:
            path = available_cascades().get(name)
            if path is None:
                raise FileNotFoundError(
                    f"cascade {name!r} not found; searched artifacts dir "
                    f"{artifact_dir()!r} and {_xml_search_dirs()!r}. Set "
                    "$CLFD_CASCADE_DIR or pass a .xml/.npz path.")
    if path.endswith(".npz"):
        return CascadeSpec.load(path)
    return parse_haar_xml(path, name=name)
