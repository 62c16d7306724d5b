"""The benchmark of clfacedetection_torch on one NVIDIA H100 (run.py)."""
