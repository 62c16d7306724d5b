from .cart_text import (cart_text_stages, load_cascade_directory,
                        parse_cart_text)
from .compile import (CompiledCascade, ScaledCascade, compile_cascade,
                      cv_round, scale_factors, scan_grid,
                      truncate_cascade)
from .convert import spec_from_arrays
from .haar_xml import parse_haar_xml, parse_haar_xml_bytes
from .haar_xml_writer import haar_xml_bytes, write_haar_xml
from .spec import ARRAY_FIELDS, MAX_RECTS, CascadeSpec
from .zoo import (CASCADE_NAMES, artifact_dir, available_cascades,
                  load_cascade)

__all__ = [
    "ARRAY_FIELDS", "MAX_RECTS", "CascadeSpec", "spec_from_arrays",
    "parse_haar_xml", "parse_haar_xml_bytes", "haar_xml_bytes",
    "write_haar_xml", "cart_text_stages", "load_cascade_directory",
    "parse_cart_text", "CompiledCascade", "ScaledCascade",
    "compile_cascade", "cv_round", "scale_factors", "scan_grid",
    "truncate_cascade", "CASCADE_NAMES", "artifact_dir",
    "available_cascades", "load_cascade",
]
