"""A plain PyTorch reference of BigGAN-deep for the port's CPU tests: G, D,
the hinge losses and the whole train step with Adam and G's EMA.

Written from the paper (arXiv:1809.11096, appendix B) as the authors'
BigGAN-PyTorch lays it out (`BigGANdeep.py`, `layers.py`, `train_fns.py`,
`utils.py::ema`), in the literal order of its operations, in float32 with
TF32 off (`exact_float32`). It imports torch alone: neither the port nor
JAX. The weights are dicts keyed as the port's state dicts, so one dict
feeds both. Departures from BigGAN-PyTorch, which the port shares:
  * spectral norm keeps u and v and runs one power iteration per training
    forward (`layers.SN` keeps u and the singular value);
  * batch statistics are taken as E[x^2] - E[x]^2 (torch's batch_norm
    computes the same moments in another order);
  * the attention's gamma is a (1,) tensor, its convolutions named
    `query/key/value/attention_convolution` (BigGAN's theta, phi, g, o).
The benchmark's copy (benchmark/reference/biggan_deep.py) adds a precision
switch and recomputes blocks in the backward; the two give bitwise the same
step (tests/test_torch_biggan_deep.py).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]
STATE_SUFFIXES = ("weight_u", "weight_v", "running_mean", "running_var",
                  "num_batches_tracked")
LOSS_NAMES = ("loss_discriminator_real", "loss_discriminator_fake",
              "loss_generator")
EPS = 1e-12
G_ARCH = {256: ((16, 16), (16, 8), (8, 8), (8, 4), (4, 2), (2, 1)),
          128: ((16, 16), (16, 8), (8, 4), (4, 2), (2, 1)),
          64: ((16, 16), (16, 8), (8, 4), (4, 2))}
D_ARCH = {256: ((1, 2), (2, 4), (4, 8), (8, 8), (8, 16), (16, 16)),
          128: ((1, 2), (2, 4), (4, 8), (8, 16), (16, 16)),
          64: ((1, 2), (2, 4), (4, 8), (8, 16))}


@contextlib.contextmanager
def exact_float32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def is_state(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in STATE_SUFFIXES


class Widths:
    """The shapes of one configuration, from a dict of BigGANDeepConfig's
    fields."""

    def __init__(self, cfg: dict):
        self.resolution = int(cfg["resolution"])
        self.ch = int(cfg["ch"])
        self.depth = int(cfg["depth"])
        self.ratio = int(cfg["bottleneck_ratio"])
        self.dim_z = int(cfg["dim_z"])
        self.shared_dim = int(cfg["shared_dim"])
        self.num_classes = int(cfg["num_classes"])
        self.attention = int(cfg["attention_resolution"])
        self.bottom = 4  # G's first feature map, at every resolution
        self.g_stages = [(self.ch * i, self.ch * o, self.bottom * 2 ** (s + 1))
                         for s, (i, o) in enumerate(G_ARCH[self.resolution])]
        self.d_stages = [(self.ch * i, self.ch * o,
                          self.resolution // 2 ** (s + 1))
                         for s, (i, o) in enumerate(D_ARCH[self.resolution])]
        first = [s for s, (_, _, r) in enumerate(self.d_stages)
                 if r == self.attention]
        self.d_attention_stage = first[0] if first else None


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x), min=EPS)


def spectral_weight(w, u, v, iterate: bool):
    """(w / sigma, u, v) on the (out, rest) view; with `iterate` one power
    iteration first; sigma = u^T W v with u, v held constant."""
    m = w.reshape(w.shape[0], -1)
    if iterate:
        with torch.no_grad():
            v = l2_normalize(m.T @ u)
            u = l2_normalize(m @ v)
    sigma = torch.einsum("i,ij,j->", u.detach(), m, v.detach())
    return w / sigma, u, v


def adam_(params, grads, moments, step, lr, b1, b2, eps) -> None:
    """torch's Adam update of `params` in place (no weight decay)."""
    for key, g in grads.items():
        m, v = moments.get(key, (torch.zeros_like(g), torch.zeros_like(g)))
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        moments[key] = (m, v)
        denom = (v.sqrt() / math.sqrt(1.0 - b2 ** step)) + eps
        params[key] = (params[key] - (lr / (1.0 - b1 ** step)) * m / denom
                       ).detach()


class Forward:
    """One network's forward: parameters from `params`, state read from
    `state_in` and advanced into `state_out`."""

    def __init__(self, params: Tensors, state_in: Tensors, train: bool,
                 cfg: dict):
        self.p, self.s_in, self.train = params, state_in, train
        self.s_out: Tensors = {}
        self.bn_eps, self.momentum = cfg["bn_eps"], cfg["bn_momentum"]

    def weight(self, name):
        w, u, v = spectral_weight(self.p[f"{name}.weight_orig"],
                                  self.s_in[f"{name}.weight_u"],
                                  self.s_in[f"{name}.weight_v"], self.train)
        self.s_out[f"{name}.weight_u"], self.s_out[f"{name}.weight_v"] = u, v
        return w

    def conv(self, name, x):
        w = self.weight(name)
        return F.conv2d(x, w, self.p.get(f"{name}.bias"),
                        padding=w.shape[-1] // 2)

    def linear(self, name, x):
        return F.linear(x, self.weight(name), self.p.get(f"{name}.bias"))

    def batch_norm(self, name, x):
        mean_key, var_key = f"{name}.running_mean", f"{name}.running_var"
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
            n = x.shape[0] * x.shape[2] * x.shape[3]
            m = self.momentum
            with torch.no_grad():
                self.s_out[mean_key] = ((1 - m) * self.s_in[mean_key]
                                        + m * mean)
                self.s_out[var_key] = ((1 - m) * self.s_in[var_key]
                                       + m * var * (n / (n - 1)))
        else:
            mean, var = self.s_in[mean_key], self.s_in[var_key]
        return ((x - mean[:, None, None])
                * torch.rsqrt(var + self.bn_eps)[:, None, None])

    def ccbn(self, name, x, cond):
        """`layers.ccbn`: batch_norm(x) * (1 + W_g c) + W_b c."""
        gain = 1 + self.linear(f"{name}.gain", cond)
        bias = self.linear(f"{name}.bias", cond)
        out = self.batch_norm(f"{name}.batch_norm", x)
        return out * gain[:, :, None, None] + bias[:, :, None, None]

    def bn(self, name, x):
        out = self.batch_norm(name, x)
        return (out * self.p[f"{name}.weight"][:, None, None]
                + self.p[f"{name}.bias"][:, None, None])

    def attention(self, name, x):
        """`layers.Attention`."""
        b, c, h, w = x.shape
        theta = self.conv(f"{name}.query_convolution", x)
        phi = F.max_pool2d(self.conv(f"{name}.key_convolution", x), [2, 2])
        g = F.max_pool2d(self.conv(f"{name}.value_convolution", x), [2, 2])
        theta = theta.reshape(b, c // 8, h * w)
        phi = phi.reshape(b, c // 8, h * w // 4)
        g = g.reshape(b, c // 2, h * w // 4)
        beta = F.softmax(torch.bmm(theta.transpose(1, 2), phi), -1)
        o = torch.bmm(g, beta.transpose(1, 2))
        o = self.conv(f"{name}.attention_convolution",
                      o.reshape(b, c // 2, h, w))
        return self.p[f"{name}.gamma"] * o + x


def gblock(f: Forward, name: str, x, cond, out: int, up: bool):
    """`BigGANdeep.GBlock.forward`."""
    h = f.conv(f"{name}.conv1", F.relu(f.ccbn(f"{name}.bn1", x, cond)))
    h = F.relu(f.ccbn(f"{name}.bn2", h, cond))
    if x.shape[1] != out:
        x = x[:, :out]
    if up:
        h, x = F.interpolate(h, scale_factor=2), F.interpolate(x,
                                                               scale_factor=2)
    h = f.conv(f"{name}.conv2", h)
    h = f.conv(f"{name}.conv3", F.relu(f.ccbn(f"{name}.bn3", h, cond)))
    h = f.conv(f"{name}.conv4", F.relu(f.ccbn(f"{name}.bn4", h, cond)))
    return h + x


def dblock(f: Forward, name: str, x, down: bool, learnable: bool):
    """`BigGANdeep.DBlock.forward`."""
    h = f.conv(f"{name}.conv1", F.relu(x))
    h = f.conv(f"{name}.conv2", F.relu(h))
    h = f.conv(f"{name}.conv3", F.relu(h))
    h = F.relu(h)
    if down:
        h = F.avg_pool2d(h, 2)
    h = f.conv(f"{name}.conv4", h)
    if down:
        x = F.avg_pool2d(x, 2)
    if learnable:
        x = torch.cat([x, f.conv(f"{name}.conv_sc", x)], 1)
    return h + x


def generator_forward(f: Forward, w: Widths, z, y):
    """z (B, dim_z), y (B,) -> (B, 3, R, R)."""
    cond = torch.cat([f.p["shared.weight"][y], z], 1)
    h = f.linear("linear", cond)
    h = h.reshape(h.shape[0], -1, w.bottom, w.bottom)
    for s, (cin, cout, res) in enumerate(w.g_stages):
        for i in range(w.depth):
            h = gblock(f, f"blocks.{s}.{i}", h, cond,
                       cin if i < w.depth - 1 else cout, i == w.depth - 1)
        if res == w.attention:
            h = f.attention(f"blocks.{s}.{w.depth}", h)
    return torch.tanh(f.conv("output_layer.2",
                             F.relu(f.bn("output_layer.0", h))))


def discriminator_forward(f: Forward, w: Widths, x, y):
    """images (B, 3, R, R), y (B,) -> (B, 1)."""
    h = f.conv("input_conv", x)
    for s, (cin, cout, _) in enumerate(w.d_stages):
        for i in range(w.depth):
            h = dblock(f, f"blocks.{s}.{i}", h, i == 0,
                       (cin if i == 0 else cout) != cout)
        if s == w.d_attention_stage:
            h = f.attention(f"blocks.{s}.{w.depth}", h)
    h = torch.sum(F.relu(h), [2, 3])
    out = f.linear("linear", h)
    return out + torch.sum(f.weight("embed")[y] * h, 1, keepdim=True)


def hinge_discriminator(dis_fake, dis_real):
    """`losses.loss_hinge_dis`: (real part, fake part)."""
    return (torch.mean(F.relu(1. - dis_real)),
            torch.mean(F.relu(1. + dis_fake)))


def hinge_generator(dis_fake):
    """`losses.loss_hinge_gen`."""
    return -torch.mean(dis_fake)


def m11_images(images_u8):
    return (images_u8.float() / 127.5 - 1.0).permute(0, 3, 1, 2)


def split(weights: Tensors) -> Tuple[Tensors, Tensors]:
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items() if not is_state(k)}
    state = {k: v.clone() for k, v in weights.items() if is_state(k)}
    return params, state


class Trainer:
    """The whole step on its own copy of G, D and G_ema. `step(images,
    labels, draws)`: `num_d_steps` = len(draws) - 1 D updates, each on its
    chunk of the uint8 `images` with its (z, y) of `draws`, then the G
    update on the last (z, y), Adam after each, then the EMA. Returns the
    last D update's losses and G's. `d_grads` holds each D update's
    gradients, `g_grads` the G update's, `fakes` each D update's fakes."""

    def __init__(self, cfg: dict, g_weights: Tensors, d_weights: Tensors):
        self.cfg, self.w = cfg, Widths(cfg)
        self.g, self.g_state = split(g_weights)
        self.d, self.d_state = split(d_weights)
        self.ema = {k: v.detach().clone() for k, v in g_weights.items()}
        self.g_moments: dict = {}
        self.d_moments: dict = {}
        self.steps = self.d_updates = 0
        self.fakes: List[torch.Tensor] = []

    def _adam(self, params, grads, moments, step, lr):
        b1, b2 = self.cfg["adam_betas"]
        adam_(params, grads, moments, step, lr, b1, b2, self.cfg["adam_eps"])
        for v in params.values():
            v.requires_grad_(True)

    def step(self, images, labels, draws) -> torch.Tensor:
        w, cfg = self.w, self.cfg
        x, labels = m11_images(images), labels.long()
        updates = len(draws) - 1
        rows = x.shape[0] // updates
        self.fakes, self.d_grads = [], []
        for i in range(updates):
            z, y = draws[i]
            with torch.no_grad():
                fg = Forward(self.g, self.g_state, True, cfg)
                fake = generator_forward(fg, w, z, y)
                self.g_state = {**self.g_state, **fg.s_out}
            self.fakes.append(fake)
            fd = Forward(self.d, self.d_state, True, cfg)
            out = discriminator_forward(
                fd, w, torch.cat([fake, x[i * rows:(i + 1) * rows]], 0),
                torch.cat([y, labels[i * rows:(i + 1) * rows]], 0))
            self.d_state = {**self.d_state, **fd.s_out}
            dis_fake, dis_real = torch.split(out, [rows, rows])
            loss_real, loss_fake = hinge_discriminator(dis_fake, dis_real)
            grads = torch.autograd.grad(loss_real + loss_fake,
                                        list(self.d.values()))
            self.d_grads.append(dict(zip(self.d, grads)))
            self.d_updates += 1
            self._adam(self.d, self.d_grads[-1], self.d_moments,
                       self.d_updates, cfg["d_lr"])
        z, y = draws[-1]
        fg = Forward(self.g, self.g_state, True, cfg)
        fake = generator_forward(fg, w, z, y)
        self.g_state = {**self.g_state, **fg.s_out}
        fd = Forward({k: v.detach() for k, v in self.d.items()},
                     self.d_state, True, cfg)
        loss_g = hinge_generator(discriminator_forward(fd, w, fake, y))
        self.d_state = {**self.d_state, **fd.s_out}
        grads = torch.autograd.grad(loss_g, list(self.g.values()))
        self.g_grads = dict(zip(self.g, grads))
        self.steps += 1
        self._adam(self.g, self.g_grads, self.g_moments, self.steps,
                   cfg["g_lr"])
        self._ema()
        return torch.stack([loss_real, loss_fake, loss_g]).detach()

    @torch.no_grad()
    def _ema(self) -> None:
        """`utils.ema.update(itr)` with itr = steps."""
        decay = 0.0 if self.steps < self.cfg["ema_start"] else (
            self.cfg["ema_decay"])
        source = {**self.g, **self.g_state}
        for k, t in self.ema.items():
            if t.is_floating_point():
                self.ema[k] = t * decay + source[k].detach() * (1 - decay)

    def state(self, net: str) -> Tensors:
        """"generator" / "discriminator": parameters and state as one dict,
        "ema": G_ema's."""
        if net == "ema":
            return dict(self.ema)
        params, state = ((self.g, self.g_state) if net == "generator"
                         else (self.d, self.d_state))
        return {**{k: v.detach() for k, v in params.items()}, **state}

    def generate_ema(self, z, y) -> torch.Tensor:
        """G_ema in eval mode (running statistics, stored u/v)."""
        with torch.no_grad():
            params = {k: v for k, v in self.ema.items() if not is_state(k)}
            state = {k: v for k, v in self.ema.items() if is_state(k)}
            return generator_forward(Forward(params, state, False, self.cfg),
                                     self.w, z, y)
