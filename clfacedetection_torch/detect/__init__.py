from .detector import DetectionResult, ScaleCascadeDetector
from .grouping import group_rectangles, group_rectangles_levels
from .pyramid import PyramidDetector, PyramidPlan
from .reference_impl import RefWindowEvaluator, detect_multi_scale_reference

__all__ = ["DetectionResult", "ScaleCascadeDetector", "group_rectangles",
           "group_rectangles_levels", "PyramidDetector", "PyramidPlan",
           "RefWindowEvaluator", "detect_multi_scale_reference"]
