"""The benchmark's plain reference: OpenCV 2.4's Haar detection in plain
PyTorch and numpy, written apart from the program it judges."""
