"""Image primitives over (B, H, W) tensors (``ops/image.py``). The match kernels'
module (``ops/match.py``) is imported by name: importing this package builds nothing.
"""

from vo_tpu_torch.ops.image import (
    rgb_to_gray,
    gaussian_blur,
    sobel_gradients,
    box_filter,
    maxpool2d_same,
    avgpool2d,
    bilinear_sample,
)
