"""PyTorch + CUDA port of the semantic-pyramid GAN (arXiv:2003.06221) for one
NVIDIA H100.

The JAX package `semantic_pyramid_for_image_generation_tpu` is the reference
this port is held against; module names mirror it so each counterpart is
easy to find. This package imports torch, numpy and the standard library
only (PIL lazily, for PNG encode/decode).

The port went slice by slice, each held against the JAX package:
  1. serving: the frozen VGG-16 7-tap pyramid, the eval-mode Generator, the
     artifact reader, the HTTP service, the generate / serve CLIs;
  2. the fused G/D train step: the discriminator, the training-mode layers,
     the losses and the train state;
  3-4. the kernels redesigned for Hopper (attention, both upsamples);
  5. the Trainer, `.pt` checkpoints, FID, the Places365 loader, cli/main.py;
  6. the VGG-16 fine-tune and inference CLIs, the ImageFolder loader, the
     `.pt` conversions and the serving-artifact writer;
  7. data-parallel training over processes (parallel/mesh.py);
  8. the train step's perf modes (--fused_d, --remat_vgg, --remat_blocks);
  9. sharded training state (--fsdp);
  10. the serving programs (torch.export per bucket, the kernels as custom
      ops `torch.ops.spig.*`, a reader that builds no model);
  11. the evaluation entry points (the artifact selftest, the FID-10k
      rehearsal), the reference-API helpers and the subpackages' public
      names.
The five TPU (Pallas) kernels (three forwards, two backwards) are
hand-written CUDA C++ kernels under `csrc/`, bound through ctypes and
registered as torch custom ops (`ops/cuda/`).

Subpackages:
    ops      -- spectral norm, pooling, resampling, and the CUDA kernel wrappers
    models   -- Generator, Discriminator, the VGG-16 pyramid, Inception
    data     -- the semantic mask schedule, the loaders, synthetic batches
    train    -- the fused train step, losses, state, Trainer, checkpoints
    parallel -- data-parallel and sharded training over processes
    serving  -- the artifact writer and readers, the HTTP service
    eval     -- FID and sample grids
    utils    -- devices, profiling, logging, the weight bridge from JAX
                parameters and reference `.pt` files
    cli      -- train, generate, fine-tune, convert, export, serve
    scripts  -- the artifact selftest and the FID rehearsal
"""

__version__ = "0.1.0"

from semantic_pyramid_for_image_generation_torch.config import (  # noqa: F401
    PyramidGANConfig,
)
