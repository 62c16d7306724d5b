"""Device ops of the port.  Each kernel module (``haar_front``,
``compact_kernel``, ``haar_tail2``, ``tail_walk``, ``haar_tail``,
``tail_rows``, ``chain``) holds the kernel's wrapper and its plain
PyTorch twin; ``cascade_table`` packs the cascade they all read;
``stencil`` is the ``"direct"`` strategy's matrix product;
``integral``, ``resize`` and ``canny`` are plain PyTorch (``canny`` with
its numpy specification).

The package exports the JAX package's names (``clfacedetection_tpu/ops``):
the gray conversions, the integral images and the pinned resize, all
plain PyTorch, so importing it loads no kernel module."""
from .integral import (IntegralImages, bgr_to_gray, bgr_to_gray_per_row,
                       bgra_to_gray, integral_images, invert,
                       tilted_integral)
from .resize import resize_bilinear_u8, resize_bilinear_u8_np, resize_coeffs

__all__ = [
    "IntegralImages", "bgr_to_gray", "bgr_to_gray_per_row",
    "bgra_to_gray", "integral_images",
    "invert", "tilted_integral", "resize_bilinear_u8",
    "resize_bilinear_u8_np", "resize_coeffs",
]
