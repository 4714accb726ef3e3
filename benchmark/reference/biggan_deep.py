"""The plain float32 reference of BigGAN-deep (arXiv:1809.11096, appendix
B): the bottleneck generator and discriminator, the hinge losses and the
train step with `num_d_steps` D updates per G update, Adam and G's EMA.

Written from the published description as the authors' BigGAN-PyTorch
(`BigGANdeep.py`, `layers.py`, `train_fns.py`, `utils.py::ema`) lays it
out, in the literal order of its operations: `ccbn` as
`batch_norm(x) * (1 + W_g c) + W_b c`, the attention's key and value
projected and then max-pooled with `bmm`s over (C, N) views, `G_D` running
D once over fake ++ real. The parameter names are the program's state-dict
keys so that one weights dict feeds both; otherwise nothing of the program
is read. Departures from BigGAN-PyTorch, as in the program: spectral norm
keeps u and v and takes one power iteration per training forward; batch
statistics are E[x^2] - E[x]^2. Weights and state are dicts of tensors;
see common.py for the purity of the functions and the precision switch.

`remat=True` recomputes each block in the backward, so the float32 step
fits the card at the cell's full width; it never splits the batch, which
batch norm spans.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.common import Precision, adam_, spectral_weight

STATE_SUFFIXES = ("weight_u", "weight_v", "running_mean", "running_var",
                  "num_batches_tracked")
LOSS_NAMES = ("loss_discriminator_real", "loss_discriminator_fake",
              "loss_generator")
Tensors = Dict[str, torch.Tensor]

# BigGAN-PyTorch's G_arch / D_arch: per stage the (in, out) multipliers of ch
G_ARCH = {256: ((16, 16), (16, 8), (8, 8), (8, 4), (4, 2), (2, 1)),
          128: ((16, 16), (16, 8), (8, 4), (4, 2), (2, 1)),
          64: ((16, 16), (16, 8), (8, 4), (4, 2))}
D_ARCH = {256: ((1, 2), (2, 4), (4, 8), (8, 8), (8, 16), (16, 16)),
          128: ((1, 2), (2, 4), (4, 8), (8, 16), (16, 16)),
          64: ((1, 2), (2, 4), (4, 8), (8, 16))}


def is_state(key: str) -> bool:
    """A buffer a forward reads or advances, not a trained parameter."""
    return key.rsplit(".", 1)[-1] in STATE_SUFFIXES


class Widths:
    """The shapes of one configuration (the JSON config's keys)."""

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
        self.cond = self.dim_z + self.shared_dim
        self.g_stages = [(self.ch * i, self.ch * o, self.bottom * 2 ** (s + 1))
                         for s, (i, o) in enumerate(G_ARCH[self.resolution])]
        self.d_stages = [(self.ch * i, self.ch * o,
                          self.resolution // 2 ** (s + 1))
                         for s, (i, o) in enumerate(D_ARCH[self.resolution])]
        first = [s for s, (_, _, r) in enumerate(self.d_stages)
                 if r == self.attention]
        self.d_attention_stage = first[0] if first else None


# ------------------------------------------------------------ specs --

def _sn(spec, name, out, inn, k=0, bias=True, kind="orthogonal"):
    shape = (out, inn, k, k) if k else (out, inn)
    spec[f"{name}.weight_orig"] = (shape, kind)
    if bias:
        spec[f"{name}.bias"] = ((out,), "zeros")
    spec[f"{name}.weight_u"] = ((out,), "unit")
    spec[f"{name}.weight_v"] = (((shape[1] * k * k) if k else inn,), "unit")


def _bn(spec, name, features, affine=False):
    if affine:
        spec[f"{name}.weight"] = ((features,), "ones")
        spec[f"{name}.bias"] = ((features,), "zeros")
    spec[f"{name}.running_mean"] = ((features,), "zeros")
    spec[f"{name}.running_var"] = ((features,), "ones")
    spec[f"{name}.num_batches_tracked"] = ((), "count")


def _attention_spec(spec, name, c):
    spec[f"{name}.gamma"] = ((1,), "gamma")
    for part, out, inn in (("query", c // 8, c), ("key", c // 8, c),
                           ("value", c // 2, c), ("attention", c, c // 2)):
        _sn(spec, f"{name}.{part}_convolution", out, inn, 1, bias=False)


def generator_spec(w: Widths) -> dict:
    """key -> (shape, initializer) of G's state dict ("orthogonal" marks a
    weight BigGAN-PyTorch initializes with `init.orthogonal_`, "gamma" the
    attention's gain)."""
    spec: dict = {"shared.weight": ((w.num_classes, w.shared_dim),
                                    "orthogonal")}
    _sn(spec, "linear", w.g_stages[0][0] * w.bottom ** 2, w.cond)
    for s, (cin, cout, res) in enumerate(w.g_stages):
        for i in range(w.depth):
            name, out = f"blocks.{s}.{i}", cin if i < w.depth - 1 else cout
            hidden = cin // w.ratio
            for j, c in enumerate((cin, hidden, hidden, hidden), start=1):
                _sn(spec, f"{name}.bn{j}.gain", c, w.cond, bias=False)
                _sn(spec, f"{name}.bn{j}.bias", c, w.cond, bias=False)
                _bn(spec, f"{name}.bn{j}.batch_norm", c)
            _sn(spec, f"{name}.conv1", hidden, cin, 1)
            _sn(spec, f"{name}.conv2", hidden, hidden, 3)
            _sn(spec, f"{name}.conv3", hidden, hidden, 3)
            _sn(spec, f"{name}.conv4", out, hidden, 1)
        if res == w.attention:
            _attention_spec(spec, f"blocks.{s}.{w.depth}", cout)
    last = w.g_stages[-1][1]
    _bn(spec, "output_layer.0", last, affine=True)
    _sn(spec, "output_layer.2", 3, last, 3)
    return spec


def discriminator_spec(w: Widths) -> dict:
    spec: dict = {}
    _sn(spec, "input_conv", w.d_stages[0][0], 3, 3)
    for s, (cin, cout, _) in enumerate(w.d_stages):
        for i in range(w.depth):
            name, inn = f"blocks.{s}.{i}", cin if i == 0 else cout
            hidden = cout // w.ratio
            _sn(spec, f"{name}.conv1", hidden, inn, 1)
            _sn(spec, f"{name}.conv2", hidden, hidden, 3)
            _sn(spec, f"{name}.conv3", hidden, hidden, 3)
            _sn(spec, f"{name}.conv4", cout, hidden, 1)
            if inn != cout:
                _sn(spec, f"{name}.conv_sc", cout - inn, inn, 1)
        if s == w.d_attention_stage:
            _attention_spec(spec, f"blocks.{s}.{w.depth}", cout)
    last = w.d_stages[-1][1]
    _sn(spec, "linear", 1, last)
    _sn(spec, "embed", w.num_classes, last, bias=False)
    return spec


# ------------------------------------------------------------ forward --

class Forward:
    """One network's forward: trained parameters from `params`, state read
    from `state_in` and advanced into `state_out`; `train` selects batch
    statistics and power iterations."""

    def __init__(self, params: Tensors, state_in: Tensors, train: bool,
                 precision: Precision, cfg: dict):
        self.p, self.s_in, self.train, self.q = params, state_in, train, precision
        self.s_out: Tensors = {}
        self.bn_eps, self.momentum = cfg["bn_eps"], cfg["bn_momentum"]

    def weight(self, name: str) -> torch.Tensor:
        w, u, v = spectral_weight(self.p[f"{name}.weight_orig"],
                                  self.s_in[f"{name}.weight_u"],
                                  self.s_in[f"{name}.weight_v"], self.train)
        self.s_out[f"{name}.weight_u"], self.s_out[f"{name}.weight_v"] = u, v
        return w

    def conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w = self.weight(name)
        return self.q.conv(x, w, self.p.get(f"{name}.bias"),
                           padding=w.shape[-1] // 2)

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.q.linear(x, self.weight(name), self.p.get(f"{name}.bias"))

    def batch_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """(x - mean) / sqrt(var + eps) with the batch's statistics (and a
        momentum step of the running ones) in training, else the running."""
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

    def ccbn(self, name: str, x: torch.Tensor, cond: torch.Tensor):
        """`layers.ccbn`: batch_norm(x) * (1 + W_g c) + W_b c."""
        gain = 1 + self.linear(f"{name}.gain", cond)
        bias = self.linear(f"{name}.bias", cond)
        out = self.batch_norm(f"{name}.batch_norm", x)
        return out * gain[:, :, None, None] + bias[:, :, None, None]

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """`layers.bn`: batch_norm(x) * gain + bias, learned per channel."""
        out = self.batch_norm(name, x)
        return (out * self.p[f"{name}.weight"][:, None, None]
                + self.p[f"{name}.bias"][:, None, None])

    def attention(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """`layers.Attention`: theta, phi and g projected, phi and g
        max-pooled, softmax(theta^T phi), o(g beta^T), gamma * o + x."""
        b, c, h, w = x.shape
        theta = self.conv(f"{name}.query_convolution", x)
        phi = F.max_pool2d(self.conv(f"{name}.key_convolution", x), [2, 2])
        g = F.max_pool2d(self.conv(f"{name}.value_convolution", x), [2, 2])
        theta = theta.reshape(b, c // 8, h * w)
        phi = phi.reshape(b, c // 8, h * w // 4)
        g = g.reshape(b, c // 2, h * w // 4)
        beta = F.softmax(torch.bmm(self.q(theta).transpose(1, 2),
                                   self.q(phi)), -1)
        o = torch.bmm(self.q(g), self.q(beta).transpose(1, 2))
        o = self.conv(f"{name}.attention_convolution",
                      o.reshape(b, c // 2, h, w))
        return self.p[f"{name}.gamma"] * o + x


def _run(fn, remat: bool, *args):
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def upsample(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2)


def generator_forward(f: Forward, w: Widths, z: torch.Tensor,
                      y: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """z (B, dim_z), y (B,) class indices -> (B, 3, R, R) in [-1, 1]."""
    cond = torch.cat([f.p["shared.weight"][y], z], 1)
    h = f.linear("linear", cond)
    h = h.reshape(h.shape[0], -1, w.bottom, w.bottom)
    for s, (cin, cout, res) in enumerate(w.g_stages):
        for i in range(w.depth):
            name, out = f"blocks.{s}.{i}", cin if i < w.depth - 1 else cout

            def block(x, cond, name=name, out=out, up=i == w.depth - 1):
                h = f.conv(f"{name}.conv1", F.relu(f.ccbn(f"{name}.bn1", x,
                                                          cond)))
                h = F.relu(f.ccbn(f"{name}.bn2", h, cond))
                if x.shape[1] != out:
                    x = x[:, :out]
                if up:
                    h, x = upsample(h), upsample(x)
                h = f.conv(f"{name}.conv2", h)
                h = f.conv(f"{name}.conv3", F.relu(f.ccbn(f"{name}.bn3", h,
                                                          cond)))
                h = f.conv(f"{name}.conv4", F.relu(f.ccbn(f"{name}.bn4", h,
                                                          cond)))
                return h + x

            h = _run(block, remat, h, cond)
        if res == w.attention:
            h = f.attention(f"blocks.{s}.{w.depth}", h)

    def output(h):
        return torch.tanh(f.conv("output_layer.2",
                                 F.relu(f.bn("output_layer.0", h))))

    return _run(output, remat, h)


def discriminator_forward(f: Forward, w: Widths, x: torch.Tensor,
                          y: torch.Tensor, remat: bool = False
                          ) -> torch.Tensor:
    """images (B, 3, R, R), y (B,) -> (B, 1)."""
    h = _run(lambda t: f.conv("input_conv", t), remat, x)
    for s, (cin, cout, _) in enumerate(w.d_stages):
        for i in range(w.depth):
            name = f"blocks.{s}.{i}"

            def block(x, name=name, down=i == 0,
                      learnable=(cin if i == 0 else cout) != cout):
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

            h = _run(block, remat, h)
        if s == w.d_attention_stage:
            h = f.attention(f"blocks.{s}.{w.depth}", h)
    h = torch.sum(F.relu(h), [2, 3])
    out = f.linear("linear", h)
    return out + torch.sum(f.weight("embed")[y] * h, 1, keepdim=True)


# ------------------------------------------------------------ losses --

def hinge_discriminator(dis_fake, dis_real) -> Tuple[torch.Tensor, ...]:
    return (torch.mean(F.relu(1. - dis_real)),
            torch.mean(F.relu(1. + dis_fake)))


def hinge_generator(dis_fake) -> torch.Tensor:
    return -torch.mean(dis_fake)


# ------------------------------------------------------------ steps --

def m11_images(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> x / 127.5 - 1, (B, 3, H, W)."""
    return (images_u8.float() / 127.5 - 1.0).permute(0, 3, 1, 2)


def split(weights: Tensors) -> Tuple[Tensors, Tensors]:
    """(trained parameters as fresh leaves, state) of a weights dict."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items() if not is_state(k)}
    state = {k: v.clone() for k, v in weights.items() if is_state(k)}
    return params, state


class BigGANDeepTrainer:
    """The reference's step, stepping its own copy of G, D and G_ema from
    the weights it is given. `run(images, labels, draws)` takes one step
    on `images` (uint8, `num_d_steps` chunks of rows) and `labels`, with
    `draws` the (z, y) of each D update and then of the G update, and
    returns its losses as floats; `first_grads` holds the gradients of each
    network's first update, `first_output` the first D update's fakes."""

    def __init__(self, cfg: dict, g_weights: Tensors, d_weights: Tensors,
                 precision: str = "float32", remat: bool = True,
                 batch_rows: Optional[int] = None, lr: Optional[float] = None):
        self.cfg, self.w = cfg, Widths(cfg)
        self.g, self.g_state = split(g_weights)
        self.d, self.d_state = split(d_weights)
        self.ema = {k: v.detach().clone() for k, v in g_weights.items()}
        self.g_lr = cfg["g_lr"] if lr is None else lr
        self.d_lr = cfg["d_lr"] if lr is None else lr
        self.q = Precision(precision)
        self.remat = remat
        self.batch_rows = batch_rows  # a planted fault: the rows the
        # losses are taken over (the forwards run on every row)
        self.g_moments: dict = {}
        self.d_moments: dict = {}
        self.steps = self.d_updates = 0
        self.first_grads: Dict[str, Tensors] = {}
        self.first_output: Optional[torch.Tensor] = None

    def _fwd(self, params, state, train=True):
        return Forward(params, state, train, self.q, self.cfg)

    def _adam(self, params, grads, moments, step, lr):
        b1, b2 = self.cfg["adam_betas"]
        adam_(params, grads, moments, step, lr, b1, b2, self.cfg["adam_eps"])
        for v in params.values():
            v.requires_grad_(True)

    def run(self, images: torch.Tensor, labels: torch.Tensor,
            draws: List[Tuple[torch.Tensor, torch.Tensor]]
            ) -> Dict[str, float]:
        losses = self.step(images, labels, draws)
        return dict(zip(LOSS_NAMES, losses.double().cpu().tolist()))

    def step(self, images, labels, draws) -> torch.Tensor:
        """One step; the losses in LOSS_NAMES' order (the last D
        update's)."""
        w, remat, keep = self.w, self.remat, slice(0, self.batch_rows)
        x = m11_images(images)
        labels = labels.long()
        updates = len(draws) - 1
        rows = x.shape[0] // updates
        for i in range(updates):
            z, y = draws[i]
            with torch.no_grad():
                fg = self._fwd(self.g, self.g_state)
                fake = generator_forward(fg, w, z, y)
                self.g_state = {**self.g_state, **fg.s_out}
            if self.first_output is None:
                self.first_output = fake
            fd = self._fwd(self.d, self.d_state)
            out = discriminator_forward(
                fd, w, torch.cat([fake, x[i * rows:(i + 1) * rows]], 0),
                torch.cat([y, labels[i * rows:(i + 1) * rows]], 0), remat)
            self.d_state = {**self.d_state, **fd.s_out}
            dis_fake, dis_real = torch.split(out, [rows, rows])
            loss_real, loss_fake = hinge_discriminator(dis_fake[keep],
                                                       dis_real[keep])
            grads = torch.autograd.grad(loss_real + loss_fake,
                                        list(self.d.values()))
            d_grads = dict(zip(self.d, grads))
            self.d_updates += 1
            if self.d_updates == 1:
                self.first_grads["discriminator"] = d_grads
            self._adam(self.d, d_grads, self.d_moments, self.d_updates,
                       self.d_lr)
        z, y = draws[-1]
        fg = self._fwd(self.g, self.g_state)
        fake = generator_forward(fg, w, z, y, remat)
        self.g_state = {**self.g_state, **fg.s_out}
        fd = self._fwd({k: v.detach() for k, v in self.d.items()},
                       self.d_state)
        loss_g = hinge_generator(discriminator_forward(fd, w, fake, y,
                                                       remat)[keep])
        self.d_state = {**self.d_state, **fd.s_out}
        grads = torch.autograd.grad(loss_g, list(self.g.values()))
        g_grads = dict(zip(self.g, grads))
        self.steps += 1
        self._adam(self.g, g_grads, self.g_moments, self.steps, self.g_lr)
        if self.steps == 1:
            self.first_grads["generator"] = g_grads
        self._ema()
        return torch.stack([loss_real, loss_fake, loss_g]).detach()

    @torch.no_grad()
    def _ema(self) -> None:
        """`utils.ema.update` after iteration `itr` = steps: a copy before
        `ema_start`, then target * decay + source * (1 - decay) over every
        floating entry of G's state dict."""
        decay = (0.0 if self.steps < self.cfg["ema_start"]
                 else self.cfg["ema_decay"])
        source = {**self.g, **self.g_state}
        for k, t in self.ema.items():
            if t.is_floating_point():
                self.ema[k] = t * decay + source[k].detach() * (1 - decay)

    def generator_state(self) -> Tensors:
        """G's parameters and state as one dict, keyed as the program's."""
        return {**{k: v.detach() for k, v in self.g.items()}, **self.g_state}
