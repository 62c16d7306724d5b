"""Carry cascade parameters from the JAX package's representation.

Both packages describe a cascade by the same named numpy arrays
(``ARRAY_FIELDS``); this module builds the port's ``CascadeSpec`` from
them, so a cascade parsed or edited on the JAX side runs unchanged here.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .spec import ARRAY_FIELDS, CascadeSpec

__all__ = ["spec_from_arrays"]


def spec_from_arrays(arrays: Mapping[str, np.ndarray], name: str,
                     window_w: int, window_h: int) -> CascadeSpec:
    """Build a ``CascadeSpec`` from the JAX ``CascadeSpec``'s array fields
    (``{f: getattr(jax_spec, f) for f in ARRAY_FIELDS}``).  Arrays are
    copied, so later edits on either side do not leak across."""
    missing = [f for f in ARRAY_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"missing cascade arrays: {missing}")
    return CascadeSpec(name=str(name), window_w=int(window_w),
                       window_h=int(window_h),
                       **{f: np.array(arrays[f], copy=True)
                          for f in ARRAY_FIELDS})
