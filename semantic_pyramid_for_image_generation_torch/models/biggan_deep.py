"""BigGAN-deep's generator and discriminator (Brock, Donahue and Simonyan,
arXiv:1809.11096, appendix B), each equation as the authors' BigGAN-PyTorch
writes it in `BigGANdeep.py` and `layers.py`, on the port's layers.

G: `[shared(y), z]` (the shared class embedding first, as `G.forward`
concatenates them with `--hier`) -> SN-linear -> the channel-major
(B, 16 ch, 4, 4) view; per stage `depth` bottleneck `GBlock`s, the stage's
last one upsampling, and `SelfAttention` in BigGAN's form after the stage
that ends at `attention_resolution`; BN (affine) -> ReLU -> SN 3x3 to 3
channels -> tanh. Every GBlock's four batch norms read `[shared(y), z]`.
D: SN 3x3 from 3 to ch; per stage `depth` bottleneck `DBlock`s, the first
one average-pooling and widening, with the attention after the first stage
that ends at `attention_resolution`; ReLU, a sum over H x W, an SN-linear to
1 plus the projection <SN-embedding(y), h>.

Keys follow BigGAN-PyTorch's module tree (`shared`, `linear`,
`blocks.<stage>.<block>.{bn1..bn4, conv1..conv4, conv_sc}`, the attention
as the stage's last entry, `output_layer.{0,2}`, `input_conv`, `embed`).
Departures, all of the port's layers:
  * spectral norm keeps u and v (`weight_u`, `weight_v`, the port's and
    torch's layout) where `layers.SN` keeps u and the singular value; a
    training forward runs the same single power iteration, and an eval
    forward reuses the stored vectors instead of iterating again;
  * batch norms keep their running statistics in a `batch_norm` BatchNorm2d
    (`running_mean`, `running_var`), where `ccbn` names them `stored_*`,
    and take the batch statistics in float32 as E[x^2] - E[x]^2
    (`layers._moments`): over the global batch of all ranks, as BigGAN's
    cross-replica batch norm asks for;
  * the attention's convolutions keep the port's names (`query_convolution`
    for theta, `key_convolution` for phi, `value_convolution` for g,
    `attention_convolution` for o) and its gamma is a (1,) tensor;
  * activations are NCHW-logical in channels_last memory, in the
    configuration's compute dtype with float32 parameters; the conditional
    gains and biases are computed in float32.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from semantic_pyramid_for_image_generation_torch.config import (
    BOTTOM_WIDTH,
    BigGANDeepConfig,
)
from semantic_pyramid_for_image_generation_torch.models.layers import (
    BatchNorm,
    SelfAttention,
    SNConv2d,
    SNEmbedding,
    SNLinear,
    _activate,
    _channel,
    _fused,
    _fused_norm,
    _moments,
    _SpectralNormLayer,
    advance_spectral_norm_,
)
from semantic_pyramid_for_image_generation_torch.models.vgg16 import (
    compute_dtype,
)
from semantic_pyramid_for_image_generation_torch.ops.pool import avg_pool_2d

POWER_ITERATIONS = 10  # at a random init, as the benchmark's weights have them
RELU = 0.0  # the batch norms' `negative_slope` for the ReLU that follows


def attention(config: BigGANDeepConfig, channels: int) -> SelfAttention:
    """BigGAN's attention (`layers.Attention`) at `channels`."""
    return SelfAttention(channels, project_then_pool=True, bias=False,
                         gamma_init=config.attention_gamma, eps=config.sn_eps)


class ConditioningBatchNorm(nn.Module):
    """BigGAN's `ccbn`: affine-free batch norm, then `out * gain + bias`
    with gain = 1 + W_g c and bias = W_b c, W_g and W_b bias-free SN-linears
    of the conditioning vector c = [shared(y), z] (float32)."""

    def __init__(self, features: int, config: BigGANDeepConfig):
        super().__init__()
        self.gain = SNLinear(config.cond_dim, features, bias=False,
                             eps=config.sn_eps)
        self.bias = SNLinear(config.cond_dim, features, bias=False,
                             eps=config.sn_eps)
        self.batch_norm = nn.BatchNorm2d(features, eps=config.bn_eps,
                                         momentum=config.bn_momentum,
                                         affine=False)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                projected: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                negative_slope: Optional[float] = None) -> torch.Tensor:
        """`projected`: (W_g c, W_b c) when the caller has computed them
        (`GBlock`, through `sn_linears`); `negative_slope`: the activation
        that follows (`layers._activate`; `GBlock` passes ReLU's 0)."""
        bn = self.batch_norm
        gain_c, bias_c = projected if projected is not None else (
            self.gain(cond), self.bias(cond))
        gain = 1.0 + gain_c
        if _fused(x, self.training):
            return _fused_norm(x, bn, gain, bias_c, negative_slope)
        mean, var = _moments(x, bn, self.training)
        inv = torch.rsqrt(var + bn.eps)
        if x.dtype == torch.float32:
            y = (x - _channel(mean)) * _channel(inv)
            return _activate(y * _channel(gain) + _channel(bias_c),
                             negative_slope)
        # bfloat16 eval: one pass over x, x * scale + shift in float32 with
        # scale = gain * rsqrt(var + eps) and shift = bias - mean * scale per
        # (row, channel), cast back; float32 keeps the literal order
        scale = gain * inv
        shift = bias_c - mean * scale
        return _activate(torch.addcmul(_channel(shift), x, _channel(scale)
                                       ).to(x.dtype), negative_slope)


def sn_linears(layers: List[SNLinear], x: torch.Tensor
               ) -> List[torch.Tensor]:
    """`[layer(x) for layer in layers]` for bias-free SN-linears of one
    shape, in training mode with one batched power iteration and one
    batched product for all of them: each layer's u and v advance and its
    sigma is taken as its own forward takes them (models/layers.py,
    `_SpectralNormLayer`). Out of training mode, or under a checkpoint's
    recompute, each layer runs alone."""
    first = layers[0]
    if not first.training or first.recompute_guard is not None:
        return [layer(x) for layer in layers]
    w = torch.stack([layer.weight_orig for layer in layers])
    u = torch.stack([layer.weight_u for layer in layers])
    v = torch.stack([layer.weight_v for layer in layers])
    if first.spectral_update:
        with torch.no_grad():
            v = torch.bmm(u[:, None, :], w)[:, 0]
            v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True).clamp(
                min=first.eps)
            u = torch.bmm(w, v[:, :, None])[:, :, 0]
            u = u / torch.linalg.vector_norm(u, dim=1, keepdim=True).clamp(
                min=first.eps)
    sigma = torch.einsum("ni,nij,nj->n", u, w, v)
    for layer, u_i, v_i in zip(layers, u.unbind(), v.unbind()):
        layer.weight_u, layer.weight_v, layer.weight_sn = u_i, v_i, None
    out = torch.matmul(x.to(w.dtype), (w / sigma[:, None, None]).transpose(
        1, 2))
    return list(out.unbind())


def mean_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """nn.AvgPool2d(2) of a channels_last (B, C, H, W) as the mean over
    each 2x2 window of its NHWC memory; returns a channels_last tensor."""
    b, c, h, w = x.shape
    nhwc = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
    return nhwc.mean(dim=(2, 4)).permute(0, 3, 1, 2)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """`F.interpolate(x, scale_factor=2)`: each pixel a 2x2 block."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class GBlock(nn.Module):
    """`BigGANdeep.GBlock`: h = conv1(ReLU(bn1(x))) to in/ratio channels,
    ReLU(bn2(h)); x keeps its first `out` channels; with `upsample` both h
    and x go through a nearest 2x; conv2 (3x3), conv3(ReLU(bn3(h))) (3x3),
    conv4(ReLU(bn4(h))) (1x1) to `out`; returns h + x."""

    def __init__(self, in_channels: int, out_channels: int, upsample: bool,
                 config: BigGANDeepConfig):
        super().__init__()
        hidden = in_channels // config.bottleneck_ratio
        eps = config.sn_eps
        self.out_channels, self.upsample = out_channels, upsample
        self.conv1 = SNConv2d(in_channels, hidden, 1, padding=0, eps=eps)
        self.conv2 = SNConv2d(hidden, hidden, eps=eps)
        self.conv3 = SNConv2d(hidden, hidden, eps=eps)
        self.conv4 = SNConv2d(hidden, out_channels, 1, padding=0, eps=eps)
        self.bn1 = ConditioningBatchNorm(in_channels, config)
        self.bn2 = ConditioningBatchNorm(hidden, config)
        self.bn3 = ConditioningBatchNorm(hidden, config)
        self.bn4 = ConditioningBatchNorm(hidden, config)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        # the eight conditional gains and biases in two batched SN-linears
        # (bn1's are wider than the other three's)
        bns = (self.bn1, self.bn2, self.bn3, self.bn4)
        first = sn_linears([self.bn1.gain, self.bn1.bias], cond)
        rest = sn_linears([layer for bn in bns[1:]
                           for layer in (bn.gain, bn.bias)], cond)
        p1, p2, p3, p4 = [first] + [rest[i:i + 2] for i in (0, 2, 4)]
        # each batch norm applies the ReLU that follows it
        h = self.conv1(self.bn1(x, cond, p1, RELU))
        h = self.bn2(h, cond, p2, RELU)
        if x.shape[1] != self.out_channels:
            x = x[:, :self.out_channels]
        if self.upsample:
            h, x = upsample_nearest_2x(h), upsample_nearest_2x(x)
        h = self.conv2(h)
        h = self.conv3(self.bn3(h, cond, p3, RELU))
        h = self.conv4(self.bn4(h, cond, p4, RELU))
        return h + x


class BigGANDeepGenerator(nn.Module):
    """(z (B, dim_z), y (B,) class indices) -> (B, 3, R, R) in [-1, 1], in
    the compute dtype, channels_last."""

    def __init__(self, config: BigGANDeepConfig = BigGANDeepConfig()):
        super().__init__()
        cfg = self.config = config
        stages = cfg.generator_stages
        self.shared = nn.Embedding(cfg.num_classes, cfg.shared_dim)
        self.linear = SNLinear(cfg.cond_dim, stages[0][0] * BOTTOM_WIDTH ** 2,
                               eps=cfg.sn_eps)
        blocks = []
        for cin, cout, resolution in stages:
            stage = [GBlock(cin, cin if i < cfg.depth - 1 else cout,
                            upsample=i == cfg.depth - 1, config=cfg)
                     for i in range(cfg.depth)]
            if resolution == cfg.attention_resolution:
                stage.append(attention(cfg, cout))
            blocks.append(nn.ModuleList(stage))
        self.blocks = nn.ModuleList(blocks)
        last = stages[-1][1]
        self.output_layer = nn.ModuleList([
            BatchNorm(last, eps=cfg.bn_eps, momentum=cfg.bn_momentum),
            nn.ReLU(),
            SNConv2d(last, 3, eps=cfg.sn_eps)])

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.config)

    def forward(self, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        cond = torch.cat([self.shared(y), z.float()], dim=1)
        h = self.linear(cond.to(self.dtype))
        h = h.view(h.shape[0], -1, BOTTOM_WIDTH, BOTTOM_WIDTH).contiguous(
            memory_format=torch.channels_last)
        for stage in self.blocks:
            for block in stage:
                h = block(h, cond) if isinstance(block, GBlock) else block(h)
        bn, _, conv = self.output_layer  # the BN applies the ReLU
        return torch.tanh(conv(bn(h, RELU)))


class DBlock(nn.Module):
    """`BigGANdeep.DBlock`: h = conv1(ReLU(x)) to out/ratio channels,
    conv2(ReLU(h)), conv3(ReLU(h)) (3x3 each), ReLU, with `downsample` a
    2x2 average pool, conv4 (1x1) to `out`; the shortcut average-pools x
    with `downsample` and, where in != out, concatenates conv_sc(x) of
    out - in channels; returns h + shortcut. In bfloat16 the pool before
    conv4 folds into it (`SNConv2d(pool=True)`) and the shortcut's runs as
    `mean_pool_2x2`; float32 keeps the literal order."""

    def __init__(self, in_channels: int, out_channels: int, downsample: bool,
                 config: BigGANDeepConfig):
        super().__init__()
        hidden = out_channels // config.bottleneck_ratio
        eps = config.sn_eps
        self.downsample = downsample
        self.conv1 = SNConv2d(in_channels, hidden, 1, padding=0, eps=eps)
        self.conv2 = SNConv2d(hidden, hidden, eps=eps)
        self.conv3 = SNConv2d(hidden, hidden, eps=eps)
        self.conv4 = SNConv2d(hidden, out_channels, 1, padding=0, eps=eps)
        self.conv_sc = (SNConv2d(in_channels, out_channels - in_channels, 1,
                                 padding=0, eps=eps)
                        if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(x))
        h = self.conv2(F.relu(h))
        h = F.relu(self.conv3(F.relu(h)))
        if not self.downsample:
            h = self.conv4(h)
        elif x.dtype == torch.float32:
            h, x = self.conv4(avg_pool_2d(h)), avg_pool_2d(x)
        else:
            # conv4(avg_pool(h)) is the folded 2x2 stride-2 conv of h, by
            # linearity, as the SP-GAN's discriminator runs in bf16; the
            # shortcut's pool as a mean over each window (torch's NHWC
            # average pool and its backward are slow at these sizes)
            h, x = self.conv4(h, pool=True), mean_pool_2x2(x)
        if self.conv_sc is not None:
            x = torch.cat([x, self.conv_sc(x)], dim=1)
        return h + x


class BigGANDeepDiscriminator(nn.Module):
    """(images (B, 3, R, R), y (B,) class indices) -> (B, 1) scores in the
    compute dtype."""

    def __init__(self, config: BigGANDeepConfig = BigGANDeepConfig()):
        super().__init__()
        cfg = self.config = config
        stages = cfg.discriminator_stages
        self.input_conv = SNConv2d(3, stages[0][0], eps=cfg.sn_eps)
        blocks, attended = [], False
        for cin, cout, resolution in stages:
            stage = [DBlock(cin if i == 0 else cout, cout, downsample=i == 0,
                            config=cfg) for i in range(cfg.depth)]
            if resolution == cfg.attention_resolution and not attended:
                stage.append(attention(cfg, cout))
                attended = True
            blocks.append(nn.ModuleList(stage))
        self.blocks = nn.ModuleList(blocks)
        last = stages[-1][1]
        self.linear = SNLinear(last, 1, eps=cfg.sn_eps)
        self.embed = SNEmbedding(cfg.num_classes, last, eps=cfg.sn_eps)

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.config)

    def forward(self, images: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = self.input_conv(images.to(self.dtype).contiguous(
            memory_format=torch.channels_last))
        for stage in self.blocks:
            for block in stage:
                h = block(h)
        h = torch.sum(F.relu(h), dim=(2, 3))
        out = self.linear(h)
        return out + torch.sum(self.embed(y).to(h.dtype) * h, dim=1,
                               keepdim=True)


@torch.no_grad()
def orthogonal_init_(module: nn.Module,
                     rng: Optional[torch.Generator] = None) -> None:
    """BigGAN-PyTorch's `--G_init ortho --D_init ortho`: every convolution,
    linear and embedding weight drawn by `nn.init.orthogonal_`, biases zero,
    the attention's gamma at its init; then POWER_ITERATIONS power
    iterations bring each spectral layer's u and v to its top singular
    vectors."""
    for m in module.modules():
        if isinstance(m, _SpectralNormLayer):
            nn.init.orthogonal_(m.weight_orig, generator=rng)
            if m.bias is not None:
                m.bias.zero_()
            for buf in (m.weight_u, m.weight_v):
                buf.normal_(generator=rng)
                buf.div_(buf.norm().clamp(min=m.eps))
        elif isinstance(m, nn.Embedding):
            nn.init.orthogonal_(m.weight, generator=rng)
        elif isinstance(m, SelfAttention):
            m.initialize(rng)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    advance_spectral_norm_(module, POWER_ITERATIONS)


def make_biggan_deep(config: BigGANDeepConfig, device: torch.device,
                     rng: Optional[torch.Generator] = None):
    """(G, D) on `device`, in training mode and channels_last memory; with
    `rng` (a torch.Generator on `device`) the weights are drawn from it."""
    with torch.device(device):
        generator = BigGANDeepGenerator(config)
        discriminator = BigGANDeepDiscriminator(config)
    for net in (generator, discriminator):
        orthogonal_init_(net, rng)
        net.to(memory_format=torch.channels_last).train()
    return generator, discriminator
