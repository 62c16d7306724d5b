"""Device ops of the port.  Each kernel module (``haar_front``,
``compact_kernel``, ``haar_tail2``, ``haar_tail``, ``tail_rows``,
``chain``) holds the kernel's wrapper and its plain PyTorch twin;
``cascade_table`` packs the cascade they all read; ``stencil`` is the
``"direct"`` strategy's matrix product; ``integral``, ``resize`` and
``canny`` are plain PyTorch (``canny`` with its numpy specification)."""
