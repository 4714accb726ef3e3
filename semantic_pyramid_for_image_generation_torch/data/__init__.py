"""Data: the semantic mask schedule, the Places365 and ImageFolder loaders
and synthetic batches. The mask API is re-exported here, as the JAX
package's data/__init__.py does."""

from semantic_pyramid_for_image_generation_torch.data.masks import (  # noqa: F401
    MaskSchedule,
    get_masks_for_inference,
    get_masks_for_training,
    get_masks_for_validation,
)
