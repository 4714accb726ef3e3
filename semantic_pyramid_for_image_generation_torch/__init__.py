"""PyTorch + CUDA port of the semantic-pyramid GAN (arXiv:2003.06221) for one
NVIDIA H100.

The JAX package `semantic_pyramid_for_image_generation_tpu` is the reference
this port is held against; module names mirror it so each counterpart is
easy to find. This package imports torch, numpy and the standard library
only (PIL lazily, for PNG encode/decode).

Slice 1 ports the serving path: the frozen VGG-16 7-tap pyramid, the
eval-mode Generator, the batch-bucketed artifact reader, the HTTP service and
the generate / serve CLIs. The three TPU (Pallas) forward kernels on that
path are hand-written CUDA C++ kernels under `csrc/`, bound through ctypes
(`ops/cuda/`).

Subpackages:
    ops      -- spectral norm, pooling, resampling, and the CUDA kernel wrappers
    models   -- Generator (eval mode) and the VGG-16 pyramid
    data     -- the semantic mask schedule
    train    -- the eval-mode generate function
    serving  -- the artifact reader and the HTTP service
    eval     -- sample grids
    utils    -- weight bridge from JAX parameters / reference `.pt` files
    cli      -- generate and serve entry points
"""

__version__ = "0.1.0"

from semantic_pyramid_for_image_generation_torch.config import (  # noqa: F401
    PyramidGANConfig,
)
