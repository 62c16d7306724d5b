from .testimage import (PHOTO_FACE_BOX, photo_gray, photo_scene, synth_face,
                        synth_scene)
from .timing import ElapseTime, profile_trace, time_torch

__all__ = ["synth_face", "synth_scene", "photo_gray", "photo_scene",
           "PHOTO_FACE_BOX", "ElapseTime", "time_torch", "profile_trace"]
