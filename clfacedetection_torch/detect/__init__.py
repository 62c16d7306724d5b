from .detector import DetectionResult
from .grouping import group_rectangles
from .pyramid import PyramidDetector, PyramidPlan

__all__ = ["DetectionResult", "group_rectangles", "PyramidDetector",
           "PyramidPlan"]
