"""Frechet Inception Distance, counterpart of the JAX package's eval/fid.py.

Pipeline:
  * per-sample min-max normalization to [-1, 1];
  * bilinear resize to 299x299 with half-pixel centers (align_corners=False,
    no antialiasing);
  * InceptionV3 Mixed_7c activations pooled to 2048-d (models/inception.py);
  * per batch, the masked moments (count, sum, sum of outer products),
    accumulated on the device in float32 without TF32;
  * the FID |mu_r - mu_f|^2 + tr(S_r) + tr(S_f) - 2 tr(sqrtm(S_r S_f)): on
    the host in float64 with scipy's sqrtm (imaginary part stripped), or on
    the device in float32 through two symmetric eigendecompositions.

Batches are walked one by one and each is counted whole (rows past a
batch's `num_valid`, where given, are left out): a later batch larger than
the first is no special case. Over several ranks (parallel/mesh.py) each
rank walks its rows of the batches, and the count and moments are summed
over the ranks before the reduction, so every rank gets the FID of the
whole set. The JAX package's `fid_scan` (lax.scan over
staged groups of batches) packs dispatches for a TPU host link and has no
counterpart here.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Iterable, Mapping, Optional, Tuple

import numpy as np
import scipy.linalg
import torch

from semantic_pyramid_for_image_generation_torch.models.inception import (
    make_inception,
)
from semantic_pyramid_for_image_generation_torch.ops.resize import (
    resize_bilinear_half_pixel,
)
from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
    is_distributed,
    sum_over_ranks_,
)
from semantic_pyramid_for_image_generation_torch.utils.device import (
    exact_float32,
)

Moments = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
FEATURES = 2048  # the pooled Mixed_7c activations


def _min_max(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = images.reshape(images.shape[0], -1)
    shape = (-1,) + (1,) * (images.dim() - 1)
    return flat.amin(dim=1).reshape(shape), flat.amax(dim=1).reshape(shape)


def normalize_m1_1(images: torch.Tensor) -> torch.Tensor:
    """Per-sample min-max to [-1, 1]; the divisor is clamped, so a constant
    sample maps to all -1 instead of NaN."""
    mn, mx = _min_max(images)
    return 2.0 * (images - mn) / torch.clamp(mx - mn, min=1e-12) - 1.0


def normalize_0_1(images: torch.Tensor) -> torch.Tensor:
    """Per-sample min-max to [0, 1], with the same clamp."""
    mn, mx = _min_max(images)
    return (images - mn) / torch.clamp(mx - mn, min=1e-12)


def fid_from_statistics(mu_real: np.ndarray, cov_real: np.ndarray,
                        mu_fake: np.ndarray, cov_fake: np.ndarray) -> float:
    """The FID on the host, scipy's sqrtm with its imaginary part stripped."""
    diff = mu_real - mu_fake
    cov_mean = scipy.linalg.sqrtm(cov_real @ cov_fake)
    if np.iscomplexobj(cov_mean):
        cov_mean = cov_mean.real
    return float(diff @ diff + np.trace(cov_real) + np.trace(cov_fake)
                 - 2.0 * np.trace(cov_mean))


def statistics_from_moments(n: float, s1, s2) -> Tuple[np.ndarray, np.ndarray]:
    """(count, sum, sum of outer products) -> (mean, unbiased covariance), in
    float64 on the host: the single-pass cancellation s2 - n mu mu^T in
    float32 would perturb the FID at 10k samples."""
    s1 = np.asarray(s1, np.float64)
    s2 = np.asarray(s2, np.float64)
    mu = s1 / n
    cov = (s2 - n * np.outer(mu, mu)) / max(n - 1.0, 1.0)
    return mu, cov


def trace_sqrtm_product(cov_real: torch.Tensor,
                        cov_fake: torch.Tensor) -> torch.Tensor:
    """tr(sqrtm(S_r S_f)) on the device, as tr sqrtm(S_f^1/2 S_r S_f^1/2):
    the inner matrix is symmetric PSD, so two eigh calls replace the general
    sqrtm and the trace is the sum of the clipped eigenvalues' roots.

    Both covariances are first divided by their mean variance s (the trace
    scales by s): a random-init backbone's covariances hold entries ~1e-10,
    the inner matrix ~1e-19, and the float32 eigensolver's squares of those
    underflow (cuSOLVER then fails to converge)."""
    dim = cov_real.shape[0]
    scale = torch.clamp((torch.trace(cov_real) + torch.trace(cov_fake))
                        / (2 * dim), min=torch.finfo(cov_real.dtype).tiny)
    with exact_float32():
        w_f, v_f = torch.linalg.eigh(cov_fake / scale)
        sqrt_f = (v_f * torch.sqrt(torch.clamp(w_f, min=0.0))) @ v_f.T
        m = sqrt_f @ (cov_real / scale) @ sqrt_f
        w = torch.linalg.eigvalsh(0.5 * (m + m.T))
    return scale * torch.sqrt(torch.clamp(w, min=0.0)).sum()


def fid_from_moments_device(n: int, s1_real: torch.Tensor,
                            s2_real: torch.Tensor, s1_fake: torch.Tensor,
                            s2_fake: torch.Tensor) -> torch.Tensor:
    """The moments -> FID reduction in float32 on the moments' device; one
    scalar leaves it. The cancellation and the eigendecompositions run in
    float32, where the host path uses float64."""
    def stats(s1, s2):
        mu = s1 / n
        return mu, (s2 - n * torch.outer(mu, mu)) / max(n - 1.0, 1.0)

    mu_r, cov_r = stats(s1_real.float(), s2_real.float())
    mu_f, cov_f = stats(s1_fake.float(), s2_fake.float())
    diff = mu_r - mu_f
    return (diff @ diff + torch.trace(cov_r) + torch.trace(cov_f)
            - 2.0 * trace_sqrtm_product(cov_r, cov_f))


class FIDEvaluator:
    """Batched FID on `device`.

    `inception_state_dict=None` initializes the backbone at random (from
    `seed`): the value is then NOT a standard FID, so construction raises
    unless `allow_random=True` is passed (pipeline smoke runs and tests), and
    warns when it is. Pass a torchvision inception_v3 state dict for a
    standard FID. `device_statistics=True` reduces the moments to the FID on
    the device (float32 eigh) instead of on the host (float64 sqrtm)."""

    def __init__(self, inception_state_dict: Optional[Mapping[str, Any]] = None,
                 device: torch.device | str = "cuda",
                 allow_random: bool = False, device_statistics: bool = False,
                 seed: int = 0):
        self.device = torch.device(device)
        self.device_statistics = device_statistics
        self.random_init = inception_state_dict is None
        if self.random_init:
            if not allow_random:
                raise ValueError(
                    "FIDEvaluator requires pretrained Inception weights for a "
                    "standard FID (--load_inception). Pass allow_random=True "
                    "(CLI: --allow_random_fid) to run with a randomly "
                    "initialized backbone: pipeline smoke only, NOT a "
                    "comparable FID.")
            warnings.warn(
                "FIDEvaluator built WITHOUT pretrained Inception weights: the "
                "backbone is randomly initialized and the reported value is "
                "NOT a standard FID (pipeline smoke only).", UserWarning,
                stacklevel=2)
        self.model = make_inception(
            self.device, inception_state_dict,
            rng=torch.Generator(self.device).manual_seed(seed))
        # (count, moments) of the last fid() call, for a second reduction
        self.last_moments: Optional[Tuple[int, Moments]] = None

    def activations(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images, any range -> (B, 2048) float32."""
        with torch.inference_mode(), exact_float32():
            x = normalize_m1_1(images.to(self.device).float())
            if x.shape[1] != 299 or x.shape[2] != 299:
                x = resize_bilinear_half_pixel(x, 299, 299)
            return self.model(x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last))

    def moments(self, images: torch.Tensor,
                num_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sum, sum of outer products) of the activations of the first
        `num_valid` rows, on the device."""
        kept = self.activations(images)[:num_valid]
        with torch.inference_mode(), exact_float32():
            return kept.sum(dim=0), kept.T @ kept

    def fid(self, real_batches: Iterable[Mapping[str, Any]],
            generate_fn: Callable[[Mapping[str, Any]], torch.Tensor]) -> float:
        """FID of `generate_fn(batch)` against `batch["images"]` over the
        batches, each counted up to its `num_valid` (default: all rows)."""
        n_total, totals = 0, None
        for batch in real_batches:
            n = int(batch.get("num_valid", batch["images"].shape[0]))
            n_total += n
            new = (*self.moments(batch["images"], n),
                   *self.moments(generate_fn(batch), n))
            totals = new if totals is None else tuple(
                a + b for a, b in zip(totals, new))
        if is_distributed():
            n_total, totals = self._sum_over_ranks(n_total, totals)
        if totals is None or n_total == 0:
            raise ValueError("FID over no batches")
        self.last_moments = (n_total, totals)
        return self.reduce_moments(n_total, totals)

    def _sum_over_ranks(self, n_total: int, totals: Optional[Moments]
                        ) -> Tuple[int, Moments]:
        """The count and moments summed over the ranks, in one flat bucket;
        a rank that walked no batch adds zeros."""
        if totals is None:
            zeros = torch.zeros(FEATURES, device=self.device)
            outer = torch.zeros(FEATURES, FEATURES, device=self.device)
            totals = (zeros, outer, zeros.clone(), outer.clone())
        count = torch.full((1,), float(n_total), device=self.device)
        totals = tuple(t.clone() for t in totals)  # inference tensors
        sum_over_ranks_((count, *totals))
        return int(count.item()), totals

    def reduce_moments(self, n_total: int, totals: Moments,
                       device_statistics: Optional[bool] = None) -> float:
        """Moments -> FID, on the host (float64) or the device (float32)."""
        if self.device_statistics if device_statistics is None \
                else device_statistics:
            return float(fid_from_moments_device(n_total, *totals))
        s1r, s2r, s1f, s2f = (t.double().cpu().numpy() for t in totals)
        mu_r, cov_r = statistics_from_moments(n_total, s1r, s2r)
        mu_f, cov_f = statistics_from_moments(n_total, s1f, s2f)
        return fid_from_statistics(mu_r, cov_r, mu_f, cov_f)
