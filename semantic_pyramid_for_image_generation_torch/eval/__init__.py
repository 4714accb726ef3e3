"""Evaluation: FID (Inception moments, host and device reductions) and the
mask-sweep grids. The FID names are re-exported here, as the JAX package's
eval/__init__.py does."""

from semantic_pyramid_for_image_generation_torch.eval.fid import (  # noqa: F401
    FIDEvaluator,
    fid_from_activations,
    fid_from_statistics,
)
