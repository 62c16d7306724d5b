from .detector import DetectionResult
from .grouping import group_rectangles, group_rectangles_levels
from .pyramid import PyramidDetector, PyramidPlan

__all__ = ["DetectionResult", "group_rectangles", "group_rectangles_levels",
           "PyramidDetector", "PyramidPlan"]
