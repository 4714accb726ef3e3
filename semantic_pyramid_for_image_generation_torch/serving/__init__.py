"""Serving: the JAX artifact reader (`export.py`) and the HTTP service
(`server.py`)."""

from semantic_pyramid_for_image_generation_torch.serving.export import (  # noqa: F401
    ServingArtifact,
)
