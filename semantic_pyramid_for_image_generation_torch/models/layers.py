"""Generator and discriminator building blocks, eval and training mode.

Counterpart of the JAX package's models/layers.py. The module tree and
parameter names are the reference torch layout that the JAX package's
`utils/pt_interop.py::export_generator_state_dict` /
`export_discriminator_state_dict` emit (`weight_orig`, `weight_u`,
`weight_v`, `main_block.3`, `residual_mapping.1`, ...), so exported and
reference state dicts load with `strict=True`.

Tensors are NCHW-logical in `torch.channels_last` memory. Parameters stay
float32 and are cast to the activations' dtype at apply; batch-norm
arithmetic runs in float32 and casts back, as the JAX bf16 path does. A
training-mode batch norm of bf16 activations runs with the activation that
follows it through Kernels 6-9 (ops/cuda/batch_norm.py): float32 in
registers, one bf16 write.

Training mode (`.train()`): every forward of a spectrally-normalized layer
runs one power iteration and advances u/v; the batch norms normalize with
batch statistics in JAX's formula and advance their running statistics. Eval
mode reuses the stored u/v and running statistics.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from semantic_pyramid_for_image_generation_torch.ops.cuda.attention import (
    PooledKVAttentionFunction,
)
from semantic_pyramid_for_image_generation_torch.ops.cuda.batch_norm import (
    BatchNormApplyFunction,
    BatchNormLink,
    BatchNormStatsFunction,
)
from semantic_pyramid_for_image_generation_torch.ops.pool import (
    avg_pool_2d,
    global_avg_pool,
    max_pool_2d,
)
from semantic_pyramid_for_image_generation_torch.ops.resize import (
    upsample_bilinear_align_corners,
)
from semantic_pyramid_for_image_generation_torch.ops.spectral_norm import (
    l2_normalize,
    power_iteration,
    spectral_norm_weight,
    weight_matrix,
)
from semantic_pyramid_for_image_generation_torch.parallel.mesh import (
    all_reduce_sum,
    world_size,
)

LEAKY_SLOPE = 0.2
SN_EPS = 1e-12  # torch's spectral norm's


def lecun_normal_(weight: torch.Tensor,
                  rng: Optional[torch.Generator] = None) -> None:
    """flax `lecun_normal`: truncated N(0, 1/fan_in) cut at 2 std, rescaled so
    the truncated draw keeps variance 1/fan_in."""
    std = math.sqrt(1.0 / weight[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=rng)


class _SpectralNormLayer(nn.Module):
    """`weight_orig` / `bias` parameters and `weight_u` / `weight_v` buffers.

    Training mode runs one power iteration per forward (none when
    `spectral_update` is False, the train step's test switch) and divides by
    sigma = u^T W v, differentiable in W with the new u/v held constant. The
    new u/v are fresh tensors and the buffers are rebound to them, never
    written into: autograd keeps the previous forward's u/v for its sigma
    (the discriminator runs on real, then on fake, before one backward).

    Eval mode divides by sigma with the stored vectors; the normalized
    weight is computed once and cached in the non-persistent buffer
    `weight_sn` (the JAX export folds sigma the same way). The cache is
    keyed on the version counters of W, u and v, so an optimizer step, a
    state-dict load or any other in-place update recomputes it, and every
    training forward drops it. A layer whose W is sharded
    (parallel/mesh.py::shard_state sets `cache_normalized` False) computes
    it at every forward instead: its forward sees the gathered copy of W,
    whose version counter an update of the shard need not move, and a
    cache would keep that full-size copy alive.

    A serving program (serving/export.py) sets the non-persistent buffer
    `weight_sigma` instead, through `torch.func.functional_call`: in eval
    mode the layer then divides W by that shipped sigma, uncached, so a
    traced program reads both from its inputs.

    `eps` is the power iteration's floor on a vector's norm (torch's
    `F.normalize` eps): 1e-12 as torch's spectral norm, BigGAN's SN_eps
    where a model sets it."""

    def __init__(self, weight_shape, bias: bool, eps: float = SN_EPS):
        super().__init__()
        self.eps = eps
        rows, cols = weight_shape[0], math.prod(weight_shape[1:])
        self.weight_orig = nn.Parameter(torch.empty(weight_shape))
        self.register_parameter(
            "bias", nn.Parameter(torch.empty(rows)) if bias else None)
        self.register_buffer("weight_u", torch.empty(rows))
        self.register_buffer("weight_v", torch.empty(cols))
        self.register_buffer("weight_sn", None, persistent=False)
        self.register_buffer("weight_sigma", None, persistent=False)
        self._sn_versions = None
        self.cache_normalized = True
        self.spectral_update = True
        self.recompute_guard: Optional[RecomputeGuard] = None
        self.initialize()

    @torch.no_grad()
    def initialize(self, rng: Optional[torch.Generator] = None) -> None:
        """flax init: xavier-uniform kernel, zero bias, normalized N(0,1) u/v."""
        nn.init.xavier_uniform_(self.weight_orig, generator=rng)
        if self.bias is not None:
            self.bias.zero_()
        for buf in (self.weight_u, self.weight_v):
            buf.copy_(l2_normalize(torch.randn(
                buf.shape, generator=rng, device=buf.device)))

    def normalized_weight(self) -> torch.Tensor:
        if self.training:
            guard = self.recompute_guard
            if guard is not None and guard.replaying:
                # a checkpoint's recompute: the sigma of this layer's own
                # forward, no power iteration, the buffers left alone
                u, v = guard.vectors[self]
                sigma, _, _ = spectral_norm_weight(
                    weight_matrix(self.weight_orig), u, v, update=False)
                return self.weight_orig / sigma
            sigma, u, v = spectral_norm_weight(
                weight_matrix(self.weight_orig), self.weight_u,
                self.weight_v, update=self.spectral_update, eps=self.eps)
            if guard is not None:
                guard.vectors[self] = (u, v)
            self.weight_u, self.weight_v = u, v
            self.weight_sn = None
            return self.weight_orig / sigma
        if self.weight_sigma is not None:
            return self._divided(self.weight_sigma)
        if not self.cache_normalized:
            return self._eval_weight()
        versions = (self.weight_orig._version, self.weight_u._version,
                    self.weight_v._version)
        if self.weight_sn is None or self._sn_versions != versions:
            self.weight_sn = self._eval_weight()
            self._sn_versions = versions
        return self.weight_sn

    @torch.no_grad()
    def _eval_weight(self) -> torch.Tensor:
        sigma, _, _ = spectral_norm_weight(
            weight_matrix(self.weight_orig), self.weight_u, self.weight_v,
            update=False)
        return self._divided(sigma)

    def _divided(self, sigma: torch.Tensor) -> torch.Tensor:
        weight = self.weight_orig / sigma
        if weight.dim() == 4:
            weight = weight.contiguous(memory_format=torch.channels_last)
        return weight

    def _bias(self, dtype: torch.dtype) -> Optional[torch.Tensor]:
        return None if self.bias is None else self.bias.to(dtype)


class RecomputeGuard:
    """Keeps a checkpointed block's recompute from advancing its state again.

    A training forward advances state as it runs: each spectral layer takes
    a power iteration and rebinds u/v, each batch norm a momentum step of
    its running statistics. JAX's `nn.remat` re-runs pure functions (its
    power iteration runs outside the blocks, its batch statistics are an
    output), but `torch.utils.checkpoint` re-runs this forward during the
    backward: u/v would advance a second time and the re-run would divide
    by another sigma than the forward did, so the gradients would be
    silently wrong, and the running statistics would take their momentum
    twice. D runs on real and on fake before one backward, so by the
    recompute the buffers may hold a later pass's u/v.

    One guard per checkpointed call; `contexts` is checkpoint's
    `context_fn`. The forward context records each spectral layer's (u, v)
    (each runs once per block call); the recompute context replays them
    with no power iteration and leaves the buffers and the running
    statistics alone."""

    def __init__(self, block: nn.Module):
        self.stateful = [m for m in block.modules()
                         if isinstance(m, (_SpectralNormLayer, nn.BatchNorm2d))]
        self.vectors = {}  # spectral layer -> the (u, v) of its forward
        self.replaying = False

    def contexts(self):
        return self._bound(replaying=False), self._bound(replaying=True)

    @contextlib.contextmanager
    def _bound(self, replaying: bool):
        self.replaying = replaying
        for m in self.stateful:
            m.recompute_guard = self
        try:
            yield
        finally:
            for m in self.stateful:
                m.recompute_guard = None


def remat(block: nn.Module, *args: torch.Tensor) -> torch.Tensor:
    """`block(*args)` keeping none of its activations for the backward,
    which re-runs the block behind a `RecomputeGuard`. Without gradients
    (the D phase's G forward) the block just runs."""
    if not torch.is_grad_enabled():
        return block(*args)
    return checkpoint(block, *args, use_reentrant=False,
                      context_fn=RecomputeGuard(block).contexts)


def fold_avg_pool(weight: torch.Tensor) -> torch.Tensor:
    """(O, I, kh, kw) -> (O, I, kh+1, kw+1): the kernel whose stride-2 conv
    equals avg_pool_2x2(conv(x)), by linearity (JAX `SNConv.fold_avg_pool`):
    1/4 of the kernel summed over the four 2x2 window offsets."""
    return 0.25 * sum(F.pad(weight, (dj, 1 - dj, di, 1 - di))
                      for di in (0, 1) for dj in (0, 1))


class SNConv2d(_SpectralNormLayer):
    """Spectrally-normalized 2D convolution (stride 1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, padding: int = 1, bias: bool = True,
                 eps: float = SN_EPS):
        super().__init__((out_channels, in_channels, kernel_size, kernel_size),
                         bias, eps)
        self.padding = padding

    def forward(self, x: torch.Tensor, pool: bool = False) -> torch.Tensor:
        """conv(x); with `pool`, avg_pool_2x2(conv(x)) as one stride-2 conv of
        the folded kernel (the JAX bf16 default in the discriminator)."""
        w = self.normalized_weight()
        if pool:
            return F.conv2d(x, fold_avg_pool(w).to(x.dtype), self._bias(x.dtype),
                            stride=2, padding=self.padding)
        return F.conv2d(x, w.to(x.dtype), self._bias(x.dtype),
                        padding=self.padding)


class SNLinear(_SpectralNormLayer):
    """Spectrally-normalized linear layer; iterates on the (out, in) matrix."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 eps: float = SN_EPS):
        super().__init__((out_features, in_features), bias, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.normalized_weight().to(x.dtype),
                        self._bias(x.dtype))


class SNEmbedding(_SpectralNormLayer):
    """Spectrally-normalized class embedding of the discriminator's
    projection: the row of table / sigma for each index. Iterates on the
    (num_embeddings, features) table; the row select is exact, as JAX's
    one-hot matmul is."""

    def __init__(self, num_embeddings: int, features: int,
                 eps: float = SN_EPS):
        super().__init__((num_embeddings, features), bias=False, eps=eps)

    @torch.no_grad()
    def initialize(self, rng: Optional[torch.Generator] = None) -> None:
        """flax init: N(0, 1) table, normalized N(0,1) u/v."""
        super().initialize(rng)
        nn.init.normal_(self.weight_orig, generator=rng)

    def forward(self, index: torch.Tensor) -> torch.Tensor:
        return self.normalized_weight()[index]


def _channel(t: torch.Tensor) -> torch.Tensor:
    """(C,) or (B, C) -> broadcastable over (B, C, H, W)."""
    return t[..., None, None]


def _global_totals(sums: torch.Tensor, n: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(E[x], E[x^2], n / (n - 1)) over (B, H, W) of the global batch from
    this rank's (2, C) [sum x, sum x^2] over its n = B*H*W rows: the sums
    and the count summed over the ranks in one differentiable all-reduce."""
    c = sums.shape[1]
    count = torch.full((1,), n, dtype=torch.float32, device=sums.device)
    totals = all_reduce_sum(torch.cat([sums.reshape(-1), count]))
    n = totals[2 * c].detach()
    return totals[:c] / n, totals[c:2 * c] / n, n / (n - 1.0)


def _global_moments(x32: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`_global_totals` of a float32 x."""
    return _global_totals(torch.stack([x32.sum(dim=(0, 2, 3)),
                                       (x32 * x32).sum(dim=(0, 2, 3))]),
                          x32.numel() // x32.shape[1])


def _moments(x: torch.Tensor, bn: nn.BatchNorm2d, training: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) to normalize x with. Eval: bn's running statistics.
    Training: batch statistics over (B, H, W) of the global batch (every
    rank's rows, as GSPMD computes them in JAX) in float32, in JAX's formula
    var = E[x^2] - E[x]^2, and one momentum step of bn's running mean and
    unbiased running var (n = B*H*W), in JAX's order of operations. The
    running statistics come out the same on every rank. A checkpoint's
    recompute (`RecomputeGuard`) takes no momentum step."""
    if not training:
        return bn.running_mean, bn.running_var
    x32 = x.float()
    if world_size() == 1:
        mean = x32.mean(dim=(0, 2, 3))
        ex2 = (x32 * x32).mean(dim=(0, 2, 3))
        n = x.shape[0] * x.shape[2] * x.shape[3]
        unbiased = n / max(n - 1, 1)
    else:
        mean, ex2, unbiased = _global_moments(x32)
    return _batch_moments(bn, mean, ex2, unbiased)


def _batch_moments(bn: nn.BatchNorm2d, mean: torch.Tensor, ex2: torch.Tensor,
                   unbiased) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_moments`' training tail: var = E[x^2] - E[x]^2 and bn's momentum
    step, unless a checkpoint's recompute replays."""
    var = ex2 - mean * mean
    guard = getattr(bn, "recompute_guard", None)
    if guard is not None and guard.replaying:
        return mean, var  # a checkpoint's recompute: the step was taken
    m = bn.momentum
    with torch.no_grad():
        bn.running_mean.copy_((1.0 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1.0 - m) * bn.running_var
                             + m * (var * unbiased))
    return mean, var


def _fused(x: torch.Tensor, training: bool) -> bool:
    """Whether a batch norm of x runs Kernels 6-9 (ops/cuda/batch_norm.py):
    in training mode on bf16 activations. Float32 (the parity path) and eval
    mode keep the literal order."""
    return training and x.dtype == torch.bfloat16


def _fused_norm(x: torch.Tensor, bn: nn.BatchNorm2d, gain: torch.Tensor,
                bias: torch.Tensor, negative_slope: Optional[float]
                ) -> torch.Tensor:
    """act((x - mean) * rsqrt(var + eps) * gain + bias) for float32 tables
    gain, bias of one row (per channel) or one per sample, with `_moments`'
    batch statistics and momentum step: Kernel 6's sums, the statistics and
    tables as small ops on (C,) and (B, C), then Kernel 7 applies
    x * scale + shift and the activation in one pass; the backward is
    Kernels 8 and 9."""
    x = x.contiguous(memory_format=torch.channels_last)
    link = BatchNormLink()
    sums = BatchNormStatsFunction.apply(x, link)
    n = x.numel() // x.shape[1]
    if world_size() == 1:
        mean, ex2, unbiased = sums[0] / n, sums[1] / n, n / max(n - 1, 1)
    else:
        mean, ex2, unbiased = _global_totals(sums, n)
    mean, var = _batch_moments(bn, mean, ex2, unbiased)
    scale = gain * torch.rsqrt(var + bn.eps)
    shift = bias - mean * scale
    slope = 1.0 if negative_slope is None else negative_slope
    return BatchNormApplyFunction.apply(x, scale.contiguous(),
                                        shift.contiguous(), slope, link)


def _activate(y: torch.Tensor, negative_slope: Optional[float]
              ) -> torch.Tensor:
    """No activation (None), ReLU (0) or LeakyReLU(negative_slope)."""
    if negative_slope is None:
        return y
    if negative_slope == 0.0:
        return F.relu(y)
    return F.leaky_relu(y, negative_slope)


class ConditionalBatchNorm(nn.Module):
    """Class-conditional batch norm: affine-free BN (momentum 0.001), then a
    per-class (scale, bias) row of an embedding table initialized to (1, 0).
    Keys: `batch_norm.running_*`, `embedding.weight`. `negative_slope`: the
    activation that follows (`_activate`), fused into the bf16 training
    pass."""

    def __init__(self, features: int, num_classes: int,
                 momentum: float = 0.001, eps: float = 1e-5):
        super().__init__()
        self.features = features
        self.batch_norm = nn.BatchNorm2d(features, eps=eps, momentum=momentum,
                                         affine=False)
        self.embedding = nn.Embedding(num_classes, 2 * features)
        self.initialize()

    @torch.no_grad()
    def initialize(self, rng: Optional[torch.Generator] = None) -> None:
        self.embedding.weight[:, :self.features] = 1.0
        self.embedding.weight[:, self.features:] = 0.0
        self.batch_norm.reset_running_stats()

    def forward(self, x: torch.Tensor, class_onehot: torch.Tensor,
                negative_slope: Optional[float] = None) -> torch.Tensor:
        bn = self.batch_norm
        row = self.embedding.weight[class_onehot.argmax(dim=-1)]
        scale, bias = row[:, :self.features], row[:, self.features:]
        if _fused(x, self.training):
            return _fused_norm(x, bn, scale, bias, negative_slope)
        mean, var = _moments(x, bn, self.training)
        inv = torch.rsqrt(var + bn.eps)
        y = (x.float() - _channel(mean)) * _channel(inv)
        return _activate((_channel(scale) * y + _channel(bias)).to(x.dtype),
                         negative_slope)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (affine, momentum 0.1), float32 arithmetic in the JAX
    order: (x - mean) * (rsqrt(var + eps) * scale) + bias; then the
    activation of `negative_slope`, fused into the bf16 training pass."""

    def forward(self, x: torch.Tensor,
                negative_slope: Optional[float] = None) -> torch.Tensor:
        if _fused(x, self.training):
            return _fused_norm(x, self, self.weight[None], self.bias[None],
                               negative_slope)
        mean, var = _moments(x, self, self.training)
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - _channel(mean)) * _channel(inv)
        return _activate((y + _channel(self.bias)).to(x.dtype),
                         negative_slope)


class Upsample2x(nn.Module):
    """nn.UpsamplingBilinear2d(scale_factor=2) through Kernel 3."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_bilinear_align_corners(x)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) channels_last -> (B, H*W, C), a view of NHWC memory."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c).contiguous()


class SelfAttention(nn.Module):
    """SAGAN self-attention with 2x max-pooled keys/values (Kernel 2); the
    core runs Kernel 1.

    The defaults are the Semantic Pyramid GAN's: x is pooled, then the key
    and value convolutions project it (`k = key(max_pool(x))`), every
    convolution has a bias, and gamma starts at 1.0. BigGAN's form
    (`layers.Attention`) is `project_then_pool=True, bias=False,
    gamma_init=0.0`: the key and value convolutions project x and their
    outputs are pooled (`phi = max_pool(conv(x))`), with no biases. The two
    compute different functions. The keys are the same in both
    (`query_convolution`, `key_convolution`, `value_convolution`,
    `attention_convolution`, `gamma`: BigGAN's theta, phi, g, o and gamma);
    gamma is a (1,) tensor where BigGAN's is 0-d."""

    def __init__(self, channels: int, project_then_pool: bool = False,
                 bias: bool = True, gamma_init: float = 1.0,
                 eps: float = SN_EPS):
        super().__init__()
        c = channels
        conv = lambda cin, cout: SNConv2d(  # noqa: E731
            cin, cout, 1, padding=0, bias=bias, eps=eps)
        self.query_convolution = conv(c, c // 8)
        self.key_convolution = conv(c, c // 8)
        self.value_convolution = conv(c, c // 2)
        self.attention_convolution = conv(c // 2, c)
        self.project_then_pool = project_then_pool
        self.gamma_init = gamma_init
        self.gamma = nn.Parameter(torch.full((1,), gamma_init))

    @torch.no_grad()
    def initialize(self, rng: Optional[torch.Generator] = None) -> None:
        self.gamma.fill_(self.gamma_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        if self.project_then_pool:
            q = _rows(self.query_convolution(x))
            k = _rows(max_pool_2d(self.key_convolution(x)))
            v = _rows(max_pool_2d(self.value_convolution(x)))
        else:
            pooled = max_pool_2d(x)
            q = _rows(self.query_convolution(x))
            k = _rows(self.key_convolution(pooled))
            v = _rows(self.value_convolution(pooled))
        attn = PooledKVAttentionFunction.apply(q, k, v)  # (B, H*W, C/2)
        attn = attn.reshape(b, h, w, c // 2).permute(0, 3, 1, 2)
        out = self.attention_convolution(attn)
        return self.gamma.to(x.dtype) * out + x


class GeneratorResidualBlock(nn.Module):
    """Upsampling generator block:
    main: CBN -> lrelu -> up2x -> SN3x3 -> CBN -> lrelu -> SN3x3;
    residual: up2x -> SN1x1; feature branch: SN3x3 on (masked feats ++ mask);
    output = main + residual + mapped features. In bf16 the residual runs
    up2x(SN1x1(x)), exact by linearity, as the JAX bf16 path does. Each CBN
    applies the LeakyReLU that follows it (the `nn.LeakyReLU` entries give
    the slope)."""

    def __init__(self, in_channels: int, out_channels: int, num_classes: int,
                 feature_channels: int):
        super().__init__()
        self.main_block = nn.ModuleList([
            ConditionalBatchNorm(in_channels, num_classes),
            nn.LeakyReLU(LEAKY_SLOPE),
            Upsample2x(),
            SNConv2d(in_channels, out_channels),
            ConditionalBatchNorm(out_channels, num_classes),
            nn.LeakyReLU(LEAKY_SLOPE),
            SNConv2d(out_channels, out_channels),
        ])
        self.residual_mapping = nn.ModuleList([
            Upsample2x(), SNConv2d(in_channels, out_channels, 1, padding=0)])
        self.masked_feature_mapping = SNConv2d(feature_channels + 1,
                                               out_channels)

    def forward(self, x: torch.Tensor, masked_features: torch.Tensor,
                class_onehot: torch.Tensor) -> torch.Tensor:
        cbn_1, act_1, up, conv_1, cbn_2, act_2, conv_2 = self.main_block
        y = up(cbn_1(x, class_onehot, act_1.negative_slope))
        y = conv_2(cbn_2(conv_1(y), class_onehot, act_2.negative_slope))
        up_res, res_conv = self.residual_mapping
        if x.dtype == torch.float32:
            res = res_conv(up_res(x))
        else:
            res = up_res(res_conv(x))
        return y + res + self.masked_feature_mapping(masked_features)


class LinearBlock(nn.Module):
    """Feature-injecting linear block for the fc8 / fc7 pyramid levels."""

    def __init__(self, in_features: int, out_features: int,
                 feature_features: int):
        super().__init__()
        self.main_block = nn.ModuleList([
            nn.LeakyReLU(LEAKY_SLOPE), SNLinear(in_features, out_features)])
        self.masked_feature_mapping = SNLinear(feature_features, out_features)

    def forward(self, x: torch.Tensor,
                masked_features: torch.Tensor) -> torch.Tensor:
        act, linear = self.main_block
        return linear(act(x)) + self.masked_feature_mapping(masked_features)


class DiscriminatorInputResidualBlock(nn.Module):
    """Input block: main SN3x3 -> lrelu -> SN3x3 -> avgpool2; residual
    avgpool2 -> SN1x1 (the pool comes *before* the 1x1). In bf16 both pools
    fold into their convs (SNConv2d(pool=True)), as the JAX bf16 default
    does; float32 keeps the literal conv -> pool order."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.main_block = nn.ModuleList([
            SNConv2d(in_channels, out_channels),
            nn.LeakyReLU(LEAKY_SLOPE),
            SNConv2d(out_channels, out_channels),
        ])
        self.residual_mapping = SNConv2d(in_channels, out_channels, 1,
                                         padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv_1, act, conv_2 = self.main_block
        y = act(conv_1(x))
        if x.dtype == torch.float32:
            return (avg_pool_2d(conv_2(y))
                    + self.residual_mapping(avg_pool_2d(x)))
        # conv1x1(avgpool(x)) is the folded 2x2 stride-2 conv of x
        return conv_2(y, pool=True) + self.residual_mapping(x, pool=True)


class DiscriminatorResidualBlock(nn.Module):
    """Downsampling block: lrelu -> SN3x3 -> lrelu -> SN3x3, plus an SN1x1
    residual, then avgpool2. In bf16 the pool distributes over the sum and
    folds into both convs; float32 keeps the literal order."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.main_block = nn.ModuleList([
            nn.LeakyReLU(LEAKY_SLOPE),
            SNConv2d(in_channels, out_channels),
            nn.LeakyReLU(LEAKY_SLOPE),
            SNConv2d(out_channels, out_channels),
        ])
        self.residual_mapping = SNConv2d(in_channels, out_channels, 1,
                                         padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act_1, conv_1, act_2, conv_2 = self.main_block
        y = act_2(conv_1(act_1(x)))
        if x.dtype == torch.float32:
            return avg_pool_2d(conv_2(y) + self.residual_mapping(x))
        return conv_2(y, pool=True) + self.residual_mapping(x, pool=True)


class GlobalAvgPool(nn.Module):
    """nn.AdaptiveAvgPool2d((1, 1)) + flatten: (B, C, H, W) -> (B, C)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return global_avg_pool(x)


@torch.no_grad()
def advance_spectral_norm_(module: nn.Module, n_iter: int) -> None:
    """Run `n_iter` power iterations on every spectrally-normalized layer of
    `module`, in place, as that many training forwards would. From a random
    init this brings sigma to the layers' spectral norms."""
    for m in module.modules():
        if isinstance(m, _SpectralNormLayer):
            u, v = power_iteration(weight_matrix(m.weight_orig), m.weight_u,
                                   m.weight_v, n_iter)
            m.weight_u.copy_(u)
            m.weight_v.copy_(v)


def set_spectral_update_(module: nn.Module, update: bool) -> None:
    """Whether training forwards of `module`'s spectrally-normalized layers
    advance u/v (the default) or reuse the stored vectors."""
    for m in module.modules():
        if isinstance(m, _SpectralNormLayer):
            m.spectral_update = update


def initialize_(module: nn.Module, rng: Optional[torch.Generator] = None) -> None:
    """Re-draw every weight of `module` with the flax initializers from `rng`
    (a torch.Generator on the module's device; None uses torch's global RNG)."""
    for m in module.modules():
        if hasattr(m, "initialize"):
            m.initialize(rng)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
