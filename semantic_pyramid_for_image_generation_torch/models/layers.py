"""Generator building blocks, eval mode.

Counterpart of the JAX package's models/layers.py for the serving path. The
module tree and parameter names are the reference torch layout that the JAX
package's `utils/pt_interop.py::export_generator_state_dict` emits
(`weight_orig`, `weight_u`, `weight_v`, `main_block.3`,
`residual_mapping.1`, ...), so exported and reference state dicts load with
`strict=True`.

Tensors are NCHW-logical in `torch.channels_last` memory. Parameters stay
float32 and are cast to the activations' dtype at apply; batch-norm
arithmetic runs in float32 and casts back, as the JAX bf16 path does.
Training-mode forwards (power iteration, batch statistics) arrive with the
training slice; these modules raise in training mode.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from semantic_pyramid_for_image_generation_torch.ops.cuda.attention import (
    pooled_kv_attention,
)
from semantic_pyramid_for_image_generation_torch.ops.pool import max_pool_2d
from semantic_pyramid_for_image_generation_torch.ops.resize import (
    upsample_bilinear_align_corners,
)
from semantic_pyramid_for_image_generation_torch.ops.spectral_norm import (
    l2_normalize,
    power_iteration,
    spectral_norm_weight,
    weight_matrix,
)

LEAKY_SLOPE = 0.2


def _eval_only(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: only the eval-mode forward is ported; "
            "call .eval() (training mode arrives with the training slice)")


def lecun_normal_(weight: torch.Tensor,
                  rng: Optional[torch.Generator] = None) -> None:
    """flax `lecun_normal`: truncated N(0, 1/fan_in) cut at 2 std, rescaled so
    the truncated draw keeps variance 1/fan_in."""
    std = math.sqrt(1.0 / weight[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=rng)


class _SpectralNormLayer(nn.Module):
    """`weight_orig` / `bias` parameters and `weight_u` / `weight_v` buffers.

    Eval mode divides by sigma = u^T W v with the stored vectors; the
    normalized weight is computed once and cached in the non-persistent
    buffer `weight_sn` (the JAX export folds sigma the same way). Loading a
    state dict or re-initializing drops the cache."""

    def __init__(self, weight_shape, bias: bool):
        super().__init__()
        rows, cols = weight_shape[0], math.prod(weight_shape[1:])
        self.weight_orig = nn.Parameter(torch.empty(weight_shape))
        self.register_parameter(
            "bias", nn.Parameter(torch.empty(rows)) if bias else None)
        self.register_buffer("weight_u", torch.empty(rows))
        self.register_buffer("weight_v", torch.empty(cols))
        self.register_buffer("weight_sn", None, persistent=False)
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
        self.weight_sn = None

    def _load_from_state_dict(self, *args, **kwargs):
        self.weight_sn = None
        super()._load_from_state_dict(*args, **kwargs)

    def normalized_weight(self) -> torch.Tensor:
        _eval_only(self)
        if self.weight_sn is None:
            with torch.no_grad():
                sigma, _, _ = spectral_norm_weight(
                    weight_matrix(self.weight_orig), self.weight_u,
                    self.weight_v, update=False)
                weight = self.weight_orig / sigma
                if weight.dim() == 4:
                    weight = weight.contiguous(memory_format=torch.channels_last)
                self.weight_sn = weight
        return self.weight_sn

    def _bias(self, dtype: torch.dtype) -> Optional[torch.Tensor]:
        return None if self.bias is None else self.bias.to(dtype)


class SNConv2d(_SpectralNormLayer):
    """Spectrally-normalized 2D convolution (stride 1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, padding: int = 1, bias: bool = True):
        super().__init__((out_channels, in_channels, kernel_size, kernel_size),
                         bias)
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.normalized_weight().to(x.dtype)
        return F.conv2d(x, w, self._bias(x.dtype), padding=self.padding)


class SNLinear(_SpectralNormLayer):
    """Spectrally-normalized linear layer; iterates on the (out, in) matrix."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__((out_features, in_features), bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.normalized_weight().to(x.dtype),
                        self._bias(x.dtype))


def _channel(t: torch.Tensor) -> torch.Tensor:
    """(C,) or (B, C) -> broadcastable over (B, C, H, W)."""
    return t[..., None, None]


class ConditionalBatchNorm(nn.Module):
    """Class-conditional batch norm, eval mode: affine-free BN with running
    statistics, then a per-class (scale, bias) row of an embedding table
    initialized to (1, 0). Keys: `batch_norm.running_*`, `embedding.weight`."""

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

    def forward(self, x: torch.Tensor, class_onehot: torch.Tensor) -> torch.Tensor:
        _eval_only(self)
        bn = self.batch_norm
        inv = torch.rsqrt(bn.running_var + bn.eps)
        y = (x.float() - _channel(bn.running_mean)) * _channel(inv)
        row = self.embedding.weight[class_onehot.argmax(dim=-1)]
        scale, bias = row[:, :self.features], row[:, self.features:]
        return (_channel(scale) * y + _channel(bias)).to(x.dtype)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (affine, momentum 0.1), eval mode, float32 arithmetic in the
    JAX order: (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _eval_only(self)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - _channel(self.running_mean)) * _channel(inv)
        return (y + _channel(self.bias)).to(x.dtype)


class Upsample2x(nn.Module):
    """nn.UpsamplingBilinear2d(scale_factor=2) through Kernel 3."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_bilinear_align_corners(x)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) channels_last -> (B, H*W, C), a view of NHWC memory."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c).contiguous()


class SelfAttention(nn.Module):
    """SAGAN self-attention with 2x max-pooled keys/values (Kernel 2) and a
    learned gamma initialized to 1.0; the core runs Kernel 1."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.query_convolution = SNConv2d(c, c // 8, 1, padding=0)
        self.key_convolution = SNConv2d(c, c // 8, 1, padding=0)
        self.value_convolution = SNConv2d(c, c // 2, 1, padding=0)
        self.attention_convolution = SNConv2d(c // 2, c, 1, padding=0)
        self.gamma = nn.Parameter(torch.ones(1))

    @torch.no_grad()
    def initialize(self, rng: Optional[torch.Generator] = None) -> None:
        self.gamma.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        pooled = max_pool_2d(x)
        q = _rows(self.query_convolution(x))
        k = _rows(self.key_convolution(pooled))
        v = _rows(self.value_convolution(pooled))
        attn = pooled_kv_attention(q, k, v)  # (B, H*W, C/2)
        attn = attn.reshape(b, h, w, c // 2).permute(0, 3, 1, 2)
        out = self.attention_convolution(attn)
        return self.gamma.to(x.dtype) * out + x


class GeneratorResidualBlock(nn.Module):
    """Upsampling generator block:
    main: CBN -> lrelu -> up2x -> SN3x3 -> CBN -> lrelu -> SN3x3;
    residual: up2x -> SN1x1; feature branch: SN3x3 on (masked feats ++ mask);
    output = main + residual + mapped features. In bf16 the residual runs
    up2x(SN1x1(x)), exact by linearity, as the JAX bf16 path does."""

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
        y = up(act_1(cbn_1(x, class_onehot)))
        y = conv_2(act_2(cbn_2(conv_1(y), class_onehot)))
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
            m.weight_sn = None


def initialize_(module: nn.Module, rng: Optional[torch.Generator] = None) -> None:
    """Re-draw every weight of `module` with the flax initializers from `rng`
    (a torch.Generator on the module's device; None uses torch's global RNG)."""
    for m in module.modules():
        if hasattr(m, "initialize"):
            m.initialize(rng)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
