"""The generators' training-mode bf16 batch norms (Kernels 6-9 through
`layers._fused_norm`, their plain versions on the CPU) against the formulas
the port computed them by before: the float32 statistics in JAX's order,
the affine in float32, a cast back and the separate activation. Kept here
as the reference.

Bands: outputs within one bf16 rounding of the reference's largest value
(both compute in float32 and round once; the reference rounds once more
through its bf16 activation); gradients within 5e-3 relative L2 (the
reference's autograd takes other float32 paths); running statistics within
1e-5 relative (a mean against a sum over n). Float32 and eval mode keep the
literal path, bitwise. Imports torch and the port only.
"""

from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from semantic_pyramid_for_image_generation_torch.config import BigGANDeepConfig
from semantic_pyramid_for_image_generation_torch.models import layers
from semantic_pyramid_for_image_generation_torch.models.biggan_deep import (
    ConditioningBatchNorm,
)
from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels

BIG = BigGANDeepConfig().tiny()
RANK_WORKER = str(Path(__file__).resolve().parent / "torch_batch_norm_rank.py")
BF16 = torch.bfloat16


def _moments_ref(x, momentum, running_mean, running_var):
    """The parent's `_moments` in training on one rank: (mean, var, the new
    running mean and var)."""
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3))
    var = (x32 * x32).mean(dim=(0, 2, 3)) - mean * mean
    n = x.shape[0] * x.shape[2] * x.shape[3]
    with torch.no_grad():
        new_mean = (1.0 - momentum) * running_mean + momentum * mean
        new_var = (1.0 - momentum) * running_var + momentum * (
            var * (n / max(n - 1, 1)))
    return mean, var, new_mean, new_var


def _c(t):
    return t[..., None, None]


def _cbn_ref(x, weight, onehot, features, eps):
    """ConditionalBatchNorm then nn.LeakyReLU(0.2), the parent's order."""
    mean, var, *running = _moments_ref(x, 0.001, torch.zeros(features),
                                       torch.ones(features))
    y = (x.float() - _c(mean)) * _c(torch.rsqrt(var + eps))
    row = weight[onehot.argmax(dim=-1)]
    out = (_c(row[:, :features]) * y + _c(row[:, features:])).to(x.dtype)
    return F.leaky_relu(out, layers.LEAKY_SLOPE), running


def _bn_ref(x, weight, bias, momentum, eps, slope):
    """BatchNorm then its activation (LeakyReLU or ReLU), the parent's
    order."""
    c = x.shape[1]
    mean, var, *running = _moments_ref(x, momentum, torch.zeros(c),
                                       torch.ones(c))
    inv = torch.rsqrt(var + eps) * weight
    out = ((x.float() - _c(mean)) * _c(inv) + _c(bias)).to(x.dtype)
    act = F.relu(out) if slope == 0.0 else F.leaky_relu(out, slope)
    return act, running


def _ccbn_ref(x, gain_c, bias_c, eps, momentum):
    """BigGAN-deep's ccbn (bf16: one addcmul; float32: the literal order)
    then ReLU, the parent's order."""
    c = x.shape[1]
    mean, var, *running = _moments_ref(x, momentum, torch.zeros(c),
                                       torch.ones(c))
    if x.dtype == torch.float32:
        y = (x - _c(mean)) * _c(torch.rsqrt(var + eps))
        return F.relu(y * _c(1.0 + gain_c) + _c(bias_c)), running
    scale = (1.0 + gain_c) * torch.rsqrt(var + eps)
    shift = bias_c - mean * scale
    return F.relu(torch.addcmul(_c(shift), x, _c(scale)).to(x.dtype)), running


def _case(kind: str, seed: int = 0):
    """(module, its call on (x, tables) with the activation, the same call
    without it, the reference's, the tables, x, the slope)."""
    g = torch.Generator().manual_seed(seed)
    b, c, h, w = 4, 16, 6, 5
    x = (0.5 + 2 * torch.randn(b, c, h, w, generator=g)).to(BF16).contiguous(
        memory_format=torch.channels_last)
    if kind == "cbn_lrelu":
        m = layers.ConditionalBatchNorm(c, 5)
        with torch.no_grad():
            m.embedding.weight.add_(0.3 * torch.randn(5, 2 * c, generator=g))
        onehot = torch.eye(5)[[1, 4, 1, 0]]
        tables, slope = [m.embedding.weight], layers.LEAKY_SLOPE
        run = lambda x, t, s=slope: m(x, onehot, s)  # noqa: E731
        ref = lambda x, t: _cbn_ref(x, t[0], onehot, c,  # noqa: E731
                                    m.batch_norm.eps)
    elif kind in ("bn_lrelu", "bn_relu"):
        slope = layers.LEAKY_SLOPE if kind == "bn_lrelu" else 0.0
        m = layers.BatchNorm(c) if kind == "bn_lrelu" else layers.BatchNorm(
            c, eps=BIG.bn_eps, momentum=BIG.bn_momentum)
        with torch.no_grad():
            m.weight.copy_(1 + 0.3 * torch.randn(c, generator=g))
            m.bias.copy_(0.3 * torch.randn(c, generator=g))
        tables = [m.weight, m.bias]
        run = lambda x, t, s=slope: m(x, s)  # noqa: E731
        ref = lambda x, t: _bn_ref(x, t[0], t[1], m.momentum,  # noqa: E731
                                   m.eps, slope)
    else:  # ccbn_relu
        m = ConditioningBatchNorm(c, BIG)
        tables = [(0.3 * torch.randn(b, c, generator=g)).requires_grad_(True),
                  (0.3 * torch.randn(b, c, generator=g)).requires_grad_(True)]
        slope = 0.0
        run = lambda x, t, s=slope: m(x, None, (t[0], t[1]), s)  # noqa: E731
        ref = lambda x, t: _ccbn_ref(x, t[0], t[1], BIG.bn_eps,  # noqa: E731
                                     BIG.bn_momentum)
    m.train()
    return m, run, ref, tables, x, slope


def _bn_of(m):
    return m if isinstance(m, torch.nn.BatchNorm2d) else m.batch_norm


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


KINDS = ["cbn_lrelu", "bn_lrelu", "ccbn_relu", "bn_relu"]


@pytest.mark.parametrize("kind", KINDS)
def test_fused_bf16_training_norm_matches_the_parents_formulas(kind):
    """Output, the gradients of x and of the tables' parameters, and the
    running statistics, against the reference; no kernel counted on the
    CPU."""
    m, run, ref, tables, x, _ = _case(kind)
    kernels.reset_launch_counts()
    xg = x.clone().requires_grad_(True)
    got = run(xg, tables)
    probe = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    grads = torch.autograd.grad((got.float() * probe).sum(), [xg] + tables)
    assert sum(kernels.launch_counts().values()) == 0
    x_ref = x.clone().requires_grad_(True)
    ref_tables = [t.detach().clone().requires_grad_(True) for t in tables]
    want, (mean, var) = ref(x_ref, ref_tables)
    want_grads = torch.autograd.grad((want.float() * probe).sum(),
                                     [x_ref] + ref_tables)
    assert got.dtype == BF16 and got.is_contiguous(
        memory_format=torch.channels_last)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2.0 ** -7 * want.float().abs().max().item())
    for name, a, b in zip(["x"] + [f"table {i}" for i in range(len(tables))],
                          grads, want_grads):
        assert _rel(a, b) <= 5e-3, (name, _rel(a, b))
    bn = _bn_of(m)
    torch.testing.assert_close(bn.running_mean, mean, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(bn.running_var, var, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["float32", "eval"])
def test_float32_and_eval_norms_keep_the_literal_path(kind, mode):
    """Float32 training and bf16 eval run the parent's formulas bitwise (the
    references above in float32; eval's running statistics)."""
    m, run, ref, tables, x, slope = _case(kind)
    if mode == "float32":
        x = x.float()
        got = run(x, tables)
        want, (mean, var) = ref(x, tables)
        assert torch.equal(got, want)
        bn = _bn_of(m)
        assert torch.equal(bn.running_mean, mean)
        assert torch.equal(bn.running_var, var)
        return
    m.eval()
    bn = _bn_of(m)
    with torch.no_grad():
        bn.running_mean.copy_(torch.linspace(-1, 1, x.shape[1]))
        bn.running_var.copy_(torch.linspace(0.5, 2, x.shape[1]))
        # the norm alone, then the activation on its bf16 output
        want = layers._activate(run(x, tables, None), slope)
        assert torch.equal(run(x, tables), want)


@pytest.mark.parametrize("slope", [layers.LEAKY_SLOPE, 0.0, 1.0])
@pytest.mark.parametrize("per_row", [True, False])
def test_fused_norm_gradcheck(slope, per_row):
    """The two Functions and the tables' small ops between them in float64
    (plain versions): x's gradient is Kernel 9's one pass, from the apply's
    output gradient and the statistics' gradient."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 4, 3, 5, dtype=torch.float64, generator=g,
                    requires_grad=True)
    rows = 3 if per_row else 1
    gain, bias = (torch.randn(rows, 4, dtype=torch.float64, generator=g,
                              requires_grad=True) for _ in range(2))
    bn = torch.nn.BatchNorm2d(4, affine=False)
    assert torch.autograd.gradcheck(
        lambda x, a, b: layers._fused_norm(x, bn, a, b, slope),
        (x, gain, bias))


class _Block(torch.nn.Module):
    """A conditional norm between two convolutions, as in G's blocks."""

    def __init__(self):
        super().__init__()
        self.conv_1 = torch.nn.Conv2d(8, 16, 3, padding=1)
        self.cbn = layers.ConditionalBatchNorm(16, 5)
        self.conv_2 = torch.nn.Conv2d(16, 8, 3, padding=1)

    def forward(self, x, onehot):
        return self.conv_2(self.cbn(self.conv_1(x), onehot,
                                    layers.LEAKY_SLOPE))


def _block_run(wrap, seed=0):
    torch.manual_seed(seed)
    block = _Block().to(BF16).to(memory_format=torch.channels_last).train()
    with torch.no_grad():
        block.cbn.embedding.weight.add_(0.3 * torch.randn(5, 32).to(BF16))
    block.cbn.embedding.float()
    x = torch.randn(4, 8, 6, 6).to(BF16).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    onehot = torch.eye(5)[[0, 3, 3, 1]]
    wrap(block, x, onehot).float().square().sum().backward()
    grads = [x.grad] + [p.grad for p in block.parameters()]
    bn = block.cbn.batch_norm
    return grads, bn.running_mean.clone(), bn.running_var.clone()


def test_fused_norm_under_remat_takes_one_momentum_step():
    """Under `layers.remat` (checkpoint behind a RecomputeGuard) the block's
    recompute re-runs Kernels 6 and 7 without a second momentum step:
    gradients and running statistics bitwise the plain block's. A plain
    checkpoint, the planted fault, takes the step twice."""
    from torch.utils.checkpoint import checkpoint

    plain = _block_run(lambda m, *a: m(*a))
    remat = _block_run(lambda m, *a: layers.remat(m, *a))
    for a, b in zip(plain[0], remat[0]):
        assert torch.equal(a, b)
    assert torch.equal(plain[1], remat[1]) and torch.equal(plain[2], remat[2])
    twice = _block_run(lambda m, *a: checkpoint(m, *a, use_reentrant=False))
    assert not torch.equal(plain[1], twice[1])


@pytest.mark.parametrize("per_row", [True, False])
def test_two_gloo_ranks_take_the_global_statistics(tmp_path, per_row):
    """Two gloo ranks, each with half the rows (tests/
    torch_batch_norm_rank.py), against one process on the whole batch: the
    statistics and their gradients all-reduced, so each rank's output and
    x gradient are the whole run's rows, the tables' gradients its rows (or,
    shared, sum to the whole run's), and the running statistics equal on
    both ranks and to the whole run's. Statistics kept per rank, the
    planted fault, fail the same comparison."""
    from torch_parallel_rank import join, start

    g = torch.Generator().manual_seed(5)
    b, c = 4, 8
    rows = b if per_row else 1
    data = {"x": (0.5 + 2 * torch.randn(b, c, 5, 6, generator=g)).to(BF16),
            "gain": 1 + 0.3 * torch.randn(rows, c, generator=g),
            "bias": 0.3 * torch.randn(rows, c, generator=g),
            "probe": torch.randn(b, c, 5, 6, generator=g),
            "slope": layers.LEAKY_SLOPE}
    torch.save(data, tmp_path / "inputs.pt")
    x = data["x"].contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    gain, bias = (data[k].clone().requires_grad_(True)
                  for k in ("gain", "bias"))
    bn = torch.nn.BatchNorm2d(c, affine=False, momentum=0.1)
    y = layers._fused_norm(x, bn, gain, bias, data["slope"])
    (y.float() * data["probe"]).sum().backward()

    def ranks(fault):
        out = tmp_path / fault
        out.mkdir()
        join(start(2, [RANK_WORKER, str(tmp_path / "inputs.pt"), str(out),
                       fault]), timeout=120)
        return [torch.load(out / f"rank{r}.pt") for r in range(2)]

    def holds(got):
        joined = {k: torch.cat([r[k] for r in got]) for k in ("y", "x_grad")}
        ok = _rel(joined["y"], y) <= 2.0 ** -8 and _rel(
            joined["x_grad"], x.grad) <= 1e-3
        for k, whole in (("gain_grad", gain.grad), ("bias_grad", bias.grad)):
            part = (torch.cat([r[k] for r in got]) if per_row
                    else got[0][k] + got[1][k])
            ok = ok and _rel(part, whole) <= 1e-3
        for k in ("running_mean", "running_var"):
            ok = ok and torch.equal(got[0][k], got[1][k]) and torch.allclose(
                got[0][k], getattr(bn, k), rtol=1e-5, atol=1e-7)
        return ok

    assert holds(ranks("sound"))
    assert not holds(ranks("bn_local"))
