from .compile import (CompiledCascade, ScaledCascade, compile_cascade,
                      cv_round, scale_factors, truncate_cascade)
from .convert import spec_from_arrays
from .spec import ARRAY_FIELDS, MAX_RECTS, CascadeSpec
from .zoo import artifact_dir, load_cascade

__all__ = [
    "ARRAY_FIELDS", "MAX_RECTS", "CascadeSpec", "spec_from_arrays",
    "CompiledCascade", "ScaledCascade", "compile_cascade", "cv_round",
    "scale_factors", "truncate_cascade", "artifact_dir", "load_cascade",
]
