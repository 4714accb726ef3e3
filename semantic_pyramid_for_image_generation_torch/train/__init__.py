"""Training: the fused train step and the eval-mode generate (step.py), the
losses, the train state, the Trainer and its checkpoints. The losses are
re-exported here, as the JAX package's train/__init__.py does."""

from semantic_pyramid_for_image_generation_torch.train.losses import (  # noqa: F401
    diversity_loss,
    lsgan_discriminator_loss,
    lsgan_generator_loss,
    semantic_reconstruction_loss,
)
