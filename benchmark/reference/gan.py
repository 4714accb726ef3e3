"""The plain float32 reference of the Semantic Pyramid GAN (arXiv:2003.06221):
the frozen VGG-16 pyramid (7 taps), the SAGAN-style generator with
class-conditional batch norm, the projection discriminator, the three
losses and the fused G/D train step with Adam.

Written from the published architecture as the reference torch code lays it
out (the parameter names are that layout's state-dict keys), in the literal
order of its operations: a convolution then its pool, an upsample then its
1x1 convolution. Weights and state are dicts of tensors; see common.py for
the purity of the functions and the precision switch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.common import Precision, adam_, spectral_weight

LEAKY = 0.2
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VGG_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512, "M")
STATE_SUFFIXES = ("weight_u", "weight_v", "running_mean", "running_var",
                  "num_batches_tracked")
Tensors = Dict[str, torch.Tensor]


def is_state(key: str) -> bool:
    """A buffer a forward reads or advances, not a trained parameter."""
    return key.rsplit(".", 1)[-1] in STATE_SUFFIXES


# ------------------------------------------------------------ shapes --

class Widths:
    """The widths of one configuration (the JSON config's keys)."""

    def __init__(self, cfg: dict):
        f = float(cfg.get("channels_factor", 1.0))
        vf = int(cfg.get("vgg_width_factor", 1))
        self.image_size = int(cfg["image_size"])
        self.num_classes = int(cfg["num_classes"])
        self.latent_dim = int(cfg.get("latent_dim", 128))
        self.compat_projection = bool(cfg.get("compat_projection", True))
        self.vgg_conv = [c // vf for c in (64, 128, 256, 512, 512)]
        self.vgg_plan = [c if c == "M" else c // vf for c in VGG_PLAN]
        self.fc7 = 4096 // vf
        c = lambda x: int(x // f)  # noqa: E731
        self.g_blocks = [(c(512), c(512)), (c(512), c(512)),
                         (c(512), c(256)), (c(256), c(128)),
                         (c(128), c(64))]
        self.d_blocks = [(3, c(64)), (c(64), c(128)), (c(128), c(256)),
                         (c(256), c(256)), (c(256), c(256)),
                         (c(256), c(512)), (c(512), c(768))]


def _sn(spec, name, out, inn, k=0, bias=True):
    shape = (out, inn, k, k) if k else (out, inn)
    spec[f"{name}.weight_orig"] = (shape, "xavier")
    if bias:
        spec[f"{name}.bias"] = ((out,), "zeros")
    spec[f"{name}.weight_u"] = ((out,), "unit")
    spec[f"{name}.weight_v"] = ((math.prod(shape[1:]),), "unit")


def _bn(spec, name, features, affine):
    if affine:
        spec[f"{name}.weight"] = ((features,), "ones")
        spec[f"{name}.bias"] = ((features,), "zeros")
    spec[f"{name}.running_mean"] = ((features,), "running_mean")
    spec[f"{name}.running_var"] = ((features,), "running_var")
    spec[f"{name}.num_batches_tracked"] = ((), "count")


def _attention_spec(spec, name, c):
    spec[f"{name}.gamma"] = ((1,), "ones")
    for part, out, inn in (("query", c // 8, c), ("key", c // 8, c),
                           ("value", c // 2, c), ("attention", c, c // 2)):
        _sn(spec, f"{name}.{part}_convolution", out, inn, 1)


def generator_spec(w: Widths) -> dict:
    """key -> (shape, initializer) of the generator's state dict."""
    spec: dict = {}
    _sn(spec, "linear_layer", w.latent_dim, w.latent_dim)
    _sn(spec, "linear_block_1.main_block.1", w.num_classes, w.latent_dim)
    _sn(spec, "linear_block_1.masked_feature_mapping", w.num_classes,
        w.num_classes)
    _sn(spec, "linear_block_2.main_block.1", 2048, w.num_classes)
    _sn(spec, "linear_block_2.masked_feature_mapping", 2048, w.fc7)
    _sn(spec, "convolution_layer.1", w.g_blocks[0][0], 128, 1)
    feats = w.vgg_conv[::-1]
    index = 0
    for i, (cin, cout) in enumerate(w.g_blocks):
        name = f"main_path.{index}"
        for j, ch in ((0, cin), (4, cout)):
            _bn(spec, f"{name}.main_block.{j}.batch_norm", ch, affine=False)
            spec[f"{name}.main_block.{j}.embedding.weight"] = (
                (w.num_classes, 2 * ch), "cbn")
        _sn(spec, f"{name}.main_block.3", cout, cin, 3)
        _sn(spec, f"{name}.main_block.6", cout, cout, 3)
        _sn(spec, f"{name}.residual_mapping.1", cout, cin, 1)
        _sn(spec, f"{name}.masked_feature_mapping", cout, feats[i] + 1, 3)
        index += 1
        if i == 2:
            _attention_spec(spec, f"main_path.{index}", cout)
            index += 1
    last = w.g_blocks[-1][1]
    _bn(spec, "final_block.1", last, affine=True)
    _sn(spec, "final_block.3", last, last, 3)
    _sn(spec, "final_block.5", 3, last, 1)
    return spec


def discriminator_spec(w: Widths) -> dict:
    spec: dict = {}
    cin, cout = w.d_blocks[0]
    _sn(spec, "layers.0.main_block.0", cout, cin, 3)
    _sn(spec, "layers.0.main_block.2", cout, cout, 3)
    _sn(spec, "layers.0.residual_mapping", cout, cin, 1)
    index = 1
    for i, (cin, cout) in enumerate(w.d_blocks[1:], start=1):
        _sn(spec, f"layers.{index}.main_block.1", cout, cin, 3)
        _sn(spec, f"layers.{index}.main_block.3", cout, cout, 3)
        _sn(spec, f"layers.{index}.residual_mapping", cout, cin, 1)
        index += 1
        if i == 2:
            _attention_spec(spec, f"layers.{index}", cout)
            index += 1
    _sn(spec, f"layers.{index + 3}", 128, w.d_blocks[-1][1])
    _sn(spec, "classification", 1, 128)
    _sn(spec, "embedding", w.num_classes, 128, bias=False)
    spec["embedding.weight_orig"] = ((w.num_classes, 128), "normal")
    return spec


def vgg_spec(w: Widths) -> dict:
    spec: dict = {}
    cin = 3
    for i, item in enumerate(_vgg_layers(w)):
        if item[0] == "conv":
            spec[f"vgg16.features.{i}.weight"] = ((item[1], cin, 3, 3),
                                                  "kaiming")
            spec[f"vgg16.features.{i}.bias"] = ((item[1],), "zeros")
            cin = item[1]
    for j, (out, inn) in zip((0, 3, 6), ((w.fc7, cin * 49), (w.fc7, w.fc7),
                                          (w.num_classes, w.fc7))):
        spec[f"vgg16.classifier.{j}.weight"] = ((out, inn), "dense")
        spec[f"vgg16.classifier.{j}.bias"] = ((out,), "zeros")
    return spec


def _vgg_layers(w: Widths) -> List[tuple]:
    """torchvision's `features` sequence: ("conv", out), ("relu",), ("pool",)."""
    layers = []
    for item in w.vgg_plan:
        layers += [("pool",)] if item == "M" else [("conv", item), ("relu",)]
    return layers


# ------------------------------------------------------------ forward --

class Forward:
    """One network's forward: trained parameters from `params`, state read
    from `state_in` and advanced into `state_out`; `train` selects batch
    statistics and power iterations."""

    def __init__(self, params: Tensors, state_in: Tensors, train: bool,
                 precision: Precision):
        self.p, self.s_in, self.train, self.q = params, state_in, train, precision
        self.s_out: Tensors = {}

    def weight(self, name: str) -> torch.Tensor:
        w, u, v = spectral_weight(self.p[f"{name}.weight_orig"],
                                  self.s_in[f"{name}.weight_u"],
                                  self.s_in[f"{name}.weight_v"], self.train)
        self.s_out[f"{name}.weight_u"], self.s_out[f"{name}.weight_v"] = u, v
        return w

    def conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w = self.weight(name)
        return self.q.conv(x, w, self.p[f"{name}.bias"],
                           padding=w.shape[-1] // 2)

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.q.linear(x, self.weight(name), self.p.get(f"{name}.bias"))

    def moments(self, name: str, x: torch.Tensor, momentum: float):
        mean_key, var_key = f"{name}.running_mean", f"{name}.running_var"
        if not self.train:
            return self.s_in[mean_key], self.s_in[var_key]
        mean = x.mean(dim=(0, 2, 3))
        var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
        n = x.shape[0] * x.shape[2] * x.shape[3]
        with torch.no_grad():
            self.s_out[mean_key] = ((1 - momentum) * self.s_in[mean_key]
                                    + momentum * mean)
            self.s_out[var_key] = ((1 - momentum) * self.s_in[var_key]
                                   + momentum * var * (n / (n - 1)))
        return mean, var

    def cbn(self, name: str, x: torch.Tensor, labels: torch.Tensor):
        mean, var = self.moments(f"{name}.batch_norm", x, 0.001)
        y = (x - mean[:, None, None]) * torch.rsqrt(var + 1e-5)[:, None, None]
        row = self.p[f"{name}.embedding.weight"][labels]
        c = x.shape[1]
        return row[:, :c, None, None] * y + row[:, c:, None, None]

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        mean, var = self.moments(name, x, 0.1)
        scale = torch.rsqrt(var + 1e-5) * self.p[f"{name}.weight"]
        return ((x - mean[:, None, None]) * scale[:, None, None]
                + self.p[f"{name}.bias"][:, None, None])

    def attention(self, name: str, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        pooled = F.max_pool2d(x, 2)
        rows = lambda t: t.flatten(2).transpose(1, 2)  # noqa: E731
        q = rows(self.conv(f"{name}.query_convolution", x))
        k = rows(self.conv(f"{name}.key_convolution", pooled))
        v = rows(self.conv(f"{name}.value_convolution", pooled))
        p = torch.softmax(torch.bmm(self.q(q), self.q(k).transpose(1, 2)), -1)
        out = torch.bmm(self.q(p), self.q(v))  # (B, HW, C/2)
        out = out.transpose(1, 2).reshape(b, c // 2, h, w)
        out = self.conv(f"{name}.attention_convolution", out)
        return self.p[f"{name}.gamma"] * out + x


def _run(fn, remat: bool, *args):
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def up2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY)


def vgg_forward(f: Forward, w: Widths, images: torch.Tensor,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None,
                remat: bool = False) -> List[torch.Tensor]:
    """images (B, 3, H, W) in [-1, 1] -> the 7 taps shallow -> deep: the five
    pool outputs, ReLU(fc7) and the fc8 logits. With `dropout_masks` (two
    boolean keep masks) the classifier applies Dropout(0.5) after ReLU(fc6)
    and after the fc7 tap."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=images.device)[:, None, None]
    x = (images - mean) / std
    layers = _vgg_layers(w)
    taps = []
    stage: List[tuple] = []

    def run_stage(x, stage=None):
        for i, layer in stage:
            if layer[0] == "conv":
                x = f.q.conv(x, f.p[f"vgg16.features.{i}.weight"],
                             f.p[f"vgg16.features.{i}.bias"], padding=1)
            elif layer[0] == "relu":
                x = F.relu(x)
            else:
                x = F.max_pool2d(x, 2)
        return x

    for i, layer in enumerate(layers):
        stage.append((i, layer))
        if layer[0] == "pool":
            x = _run(lambda t, s=tuple(stage): run_stage(t, s), remat, x)
            taps.append(x)
            stage = []
    x = torch.flatten(F.adaptive_avg_pool2d(x, (7, 7)), 1)
    dense = lambda j, t: f.q.linear(  # noqa: E731
        t, f.p[f"vgg16.classifier.{j}.weight"],
        f.p[f"vgg16.classifier.{j}.bias"])
    masks = list(dropout_masks) if dropout_masks is not None else []
    x = F.relu(dense(0, x))
    if masks:
        x = torch.where(masks[0], x / 0.5, torch.zeros_like(x))
    x = F.relu(dense(3, x))
    taps.append(x)
    if masks:
        x = torch.where(masks[1], x / 0.5, torch.zeros_like(x))
    taps.append(dense(6, x))
    return taps


def generator_forward(f: Forward, w: Widths, latent, features, masks,
                      labels: torch.Tensor, remat: bool = False):
    """latent (B, latent_dim); features, masks: 7 levels shallow -> deep (conv
    masks (B, 1, h, w)); labels (B,) class indices -> (B, 3, H, W)."""
    x = f.linear("linear_layer", latent)
    for name, level in (("linear_block_1", 6), ("linear_block_2", 5)):
        x = (f.linear(f"{name}.main_block.1", lrelu(x))
             + f.linear(f"{name}.masked_feature_mapping",
                        features[level] * masks[level]))
    x = f.conv("convolution_layer.1", lrelu(x.reshape(x.shape[0], 128, 4, 4)))
    index, depth = 0, 4
    for i in range(len(w.g_blocks)):
        name = f"main_path.{index}"
        masked = torch.cat([features[depth] * masks[depth], masks[depth]], 1)

        def block(x, masked, name=name):
            y = up2x(lrelu(f.cbn(f"{name}.main_block.0", x, labels)))
            y = f.conv(f"{name}.main_block.3", y)
            y = lrelu(f.cbn(f"{name}.main_block.4", y, labels))
            y = f.conv(f"{name}.main_block.6", y)
            res = f.conv(f"{name}.residual_mapping.1", up2x(x))
            return y + res + f.conv(f"{name}.masked_feature_mapping", masked)

        x = _run(block, remat, x, masked)
        index, depth = index + 1, depth - 1
        if i == 2:
            x = f.attention(f"main_path.{index}", x)
            index += 1

    def final(x):
        x = lrelu(f.bn("final_block.1", up2x(x)))
        x = f.conv("final_block.5", lrelu(f.conv("final_block.3", x)))
        return torch.tanh(x)

    return _run(final, remat, x)


def discriminator_forward(f: Forward, w: Widths, images: torch.Tensor,
                          labels: torch.Tensor, remat: bool = False):
    """images (B, 3, H, W), labels (B,) -> (B, B, 128) with the compat
    projection (out[i, j] = score[j] + x[j] * emb[i]), else (B, 1)."""

    def input_block(x):
        y = f.conv("layers.0.main_block.2", lrelu(
            f.conv("layers.0.main_block.0", x)))
        return (F.avg_pool2d(y, 2)
                + f.conv("layers.0.residual_mapping", F.avg_pool2d(x, 2)))

    x = _run(input_block, remat, images)
    index = 1
    for i in range(1, len(w.d_blocks)):
        name = f"layers.{index}"

        def block(x, name=name):
            y = f.conv(f"{name}.main_block.1", lrelu(x))
            y = f.conv(f"{name}.main_block.3", lrelu(y))
            return F.avg_pool2d(y + f.conv(f"{name}.residual_mapping", x), 2)

        x = _run(block, remat, x)
        index += 1
        if i == 2:
            x = f.attention(f"layers.{index}", x)
            index += 1
    x = lrelu(f.linear(f"layers.{index + 3}", lrelu(x).mean(dim=(2, 3))))
    emb = f.weight("embedding")[labels]
    score = f.linear("classification", x)
    if w.compat_projection:
        return score + x * emb[:, None, :]
    return score + (x * emb).sum(-1, keepdim=True)


# ------------------------------------------------------------ losses --

def max_pool_1d(x: torch.Tensor) -> torch.Tensor:
    even = 2 * (x.shape[-1] // 2)
    return torch.maximum(x[..., 0:even:2], x[..., 1:even:2])


def reconstruction_loss(real, fake, masks) -> torch.Tensor:
    loss = 0.0
    for r, g, m in zip(real, fake, masks):
        pool = (lambda t: F.max_pool2d(t, 2)) if r.dim() == 4 else max_pool_1d
        loss = loss + torch.mean(torch.abs(pool(r) - pool(g)) * pool(m))
    return loss


def diversity_loss(fake: torch.Tensor, latent: torch.Tensor) -> torch.Tensor:
    half = fake.shape[0] // 2
    l1_z = torch.mean(torch.abs(latent[:half] - latent[half:2 * half]))
    l1_x = torch.mean(torch.abs(fake[:half] - fake[half:2 * half]))
    return l1_z / (l1_x + 1e-8)


# ------------------------------------------------------------ steps --

def m11_images(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> per-image min-max to [-1, 1], (B, 3, H, W)."""
    x = images_u8.float()
    flat = x.reshape(x.shape[0], -1)
    lo = flat.amin(1)[:, None, None, None]
    hi = flat.amax(1)[:, None, None, None]
    x = 2.0 * (x - lo) / torch.clamp(hi - lo, min=1e-12) - 1.0
    return x.permute(0, 3, 1, 2)


def nchw_masks(masks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [m.float().permute(0, 3, 1, 2) if m.dim() == 4 else m.float()
            for m in masks]


def split(weights: Tensors) -> Tuple[Tensors, Tensors]:
    """(trained parameters as fresh leaves, state) of a weights dict."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items() if not is_state(k)}
    state = {k: v.clone() for k, v in weights.items() if is_state(k)}
    return params, state


class GANTrainer:
    """The reference's fused step, stepping its own copy of G, D and the VGG
    from the weights it is given. `run(batch, noise_d, noise_g)` takes one
    step and returns its five losses as floats; `first_grads` holds the
    first step's gradients and `params` the current parameters."""

    def __init__(self, cfg: dict, g_weights: Tensors, d_weights: Tensors,
                 vgg_weights: Tensors, lr: float, w_rec: float, w_div: float,
                 precision: str = "float32", remat: bool = True,
                 batch_rows: Optional[int] = None):
        self.w = Widths(cfg)
        self.g, self.g_state = split(g_weights)
        self.d, self.d_state = split(d_weights)
        self.vgg = {k: v.detach() for k, v in vgg_weights.items()}
        self.lr, self.w_rec, self.w_div = lr, w_rec, w_div
        self.q = Precision(precision)
        self.remat = remat
        self.batch_rows = batch_rows  # a planted fault: the rows the
        # losses are taken over (the forwards run on every row)
        self.g_moments: dict = {}
        self.d_moments: dict = {}
        self.steps = 0
        self.first_grads: Dict[str, Tensors] = {}
        self.first_output: Optional[torch.Tensor] = None  # step 1's fakes

    def _fwd(self, params, state, train=True):
        return Forward(params, state, train, self.q)

    def run(self, batch: dict, noise_d: torch.Tensor,
            noise_g: torch.Tensor) -> Dict[str, float]:
        losses = self.step(batch, noise_d, noise_g)
        return dict(zip(LOSS_NAMES, losses.double().cpu().tolist()))

    def step(self, batch: dict, noise_d: torch.Tensor,
             noise_g: torch.Tensor) -> torch.Tensor:
        """One step; the five losses stacked in LOSS_NAMES' order."""
        w, remat = self.w, self.remat
        images = m11_images(batch["images"])
        labels = batch["labels"].float().argmax(-1)
        masks = nchw_masks(batch["masks"])
        keep = slice(0, self.batch_rows)  # every row when batch_rows is None
        with torch.no_grad():
            real = vgg_forward(self._fwd(self.vgg, {}, False), w, images,
                               remat=False)
            fg = self._fwd(self.g, self.g_state)
            fake_d = generator_forward(fg, w, noise_d, real, masks, labels)
            self.g_state = {**self.g_state, **fg.s_out}
            if self.steps == 0:
                self.first_output = fake_d
        # discriminator phase
        f_real = self._fwd(self.d, self.d_state)
        pred_real = discriminator_forward(f_real, w, images, labels, remat)
        state = {**self.d_state, **f_real.s_out}
        f_fake = self._fwd(self.d, state)
        pred_fake = discriminator_forward(f_fake, w, fake_d, labels, remat)
        self.d_state = {**state, **f_fake.s_out}
        loss_real = 0.5 * torch.mean(torch.square(pred_real[keep] - 1.0))
        loss_fake = 0.5 * torch.mean(torch.square(pred_fake[keep]))
        grads = torch.autograd.grad(loss_real + loss_fake, list(self.d.values()))
        d_grads = dict(zip(self.d, grads))
        self.steps += 1
        adam_(self.d, d_grads, self.d_moments, self.steps, self.lr)
        self.d = {k: v.requires_grad_(True) for k, v in self.d.items()}
        # generator phase, against the updated discriminator
        fg = self._fwd(self.g, self.g_state)
        fake = generator_forward(fg, w, noise_g, real, masks, labels, remat)
        self.g_state = {**self.g_state, **fg.s_out}
        fd = self._fwd(self.d, self.d_state)
        d_params = {k: v.detach() for k, v in self.d.items()}
        fd.p = d_params
        pred = discriminator_forward(fd, w, fake, labels, remat)
        self.d_state = {**self.d_state, **fd.s_out}
        loss_g = 0.5 * torch.mean(torch.square(pred[keep] - 1.0))
        loss_div = self.w_div * diversity_loss(fake[keep], noise_g[keep])
        fake_feats = vgg_forward(self._fwd(self.vgg, {}, False), w, fake,
                                 remat=remat)
        loss_rec = self.w_rec * reconstruction_loss(
            [r[keep] for r in real], [f[keep] for f in fake_feats],
            [m[keep] for m in masks])
        grads = torch.autograd.grad(loss_g + loss_div + loss_rec,
                                    list(self.g.values()))
        g_grads = dict(zip(self.g, grads))
        adam_(self.g, g_grads, self.g_moments, self.steps, self.lr)
        self.g = {k: v.requires_grad_(True) for k, v in self.g.items()}
        if self.steps == 1:
            self.first_grads = {"generator": g_grads, "discriminator": d_grads}
        return torch.stack([loss_real, loss_fake, loss_g, loss_rec,
                            loss_div]).detach()


LOSS_NAMES = ("loss_discriminator_real", "loss_discriminator_fake",
              "loss_generator", "loss_generator_semantic_reconstruction",
              "loss_generator_diversity")
