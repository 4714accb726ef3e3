"""Core numerical ops: spectral norm, pooling, resampling, and the CUDA
kernel wrappers (`ops.cuda`, which registers the `spig` custom ops and
builds nothing before the first launch). The names the JAX package's
ops/__init__.py exports are re-exported here."""

from semantic_pyramid_for_image_generation_torch.ops.pool import (  # noqa: F401
    adaptive_avg_pool_2d,
    avg_pool_2d,
    global_avg_pool,
    max_pool_1d,
    max_pool_2d,
)
from semantic_pyramid_for_image_generation_torch.ops.resize import (  # noqa: F401
    interpolate_nearest,
    resize_bilinear_align_corners,
    resize_bilinear_half_pixel,
    upsample_bilinear_align_corners,
)
from semantic_pyramid_for_image_generation_torch.ops.spectral_norm import (  # noqa: F401
    l2_normalize,
    spectral_norm_weight,
)
