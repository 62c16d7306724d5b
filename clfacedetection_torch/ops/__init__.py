"""Device ops of the port.  Each kernel module (``haar_front``,
``compact_kernel``, ``haar_tail2``) holds the kernel's wrapper and its
plain PyTorch twin."""
