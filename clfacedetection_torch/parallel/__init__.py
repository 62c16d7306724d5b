from .sharding import detect_sharded, gather_detections
from .strips import StripShardedPyramidDetector

__all__ = ["detect_sharded", "gather_detections",
           "StripShardedPyramidDetector"]
