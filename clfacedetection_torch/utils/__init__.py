from .testimage import synth_face, synth_scene

__all__ = ["synth_face", "synth_scene"]
