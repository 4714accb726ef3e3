"""The port's profiling entry points (semantic_pyramid_for_image_generation_
torch/scripts/{finalblock_bench,inputconv_bwd_bench,s2d_stem_bench,
profile_step}.py) against the repository's JAX scripts of the same names,
loaded through importlib (scripts/ has no __init__.py). Inputs are made from
a seed with numpy, NHWC / HWIO for JAX and transposed to NCHW / OIHW for the
port.

Held, in float32 on the CPU (the port's upsample runs its plain versions):
  * finalblock: `_stats_weights` and `upsample2_stats` against the JAX
    script's within 1e-5 relative, at several (H, W), H != W among them;
    `chain_current` and `chain_folded`, loss and the gradients of x and the
    kernel, against the JAX script's jitted `jax.grad` within 1e-4
    relative (to the largest |value|); the two chains against each other
    within the script's CHAIN_TOLERANCE (1e-4 relative);
  * inputconv: each variant's grad-x and grad-k against the JAX script's
    same variant and against the port's `no_pad`, within the script's
    TOLERANCE (1e-5 relative for grad-x, 1e-4 for grad-k); `pad_outside`'s
    gradient of the 5 padding channels is exactly 0;
  * s2d: `space_to_depth`, `scatter_kernel_s2d` and `depth_from_phases`
    bitwise against the JAX script's; each variant's output against the
    direct SAME conv within the script's TOLERANCE (1e-6 of the direct
    conv's largest |output|, a few float32 ulps there) and its gradients
    against the direct conv's within inputconv's TOLERANCE;
  * profile_step: `analyze` on a hand-written chrome trace (kernels, a
    memcpy, CPU ops with shapes, External ids; two steps) gives the exact
    category shares, top-op order, launches per step, bound_by, FLOP rate,
    busy share and MFU; `--analyze_only` re-reads a kept log dir; at the
    tiny config on the CPU (1 step) the report has every key, and
    `count_flops` over the tiny VGG-16's forward equals its hand count
    (convolutions and dense layers, 2 FLOPs a multiply-add) and over the
    attention kernel's op its two products;
  * each script refuses `--device cuda` on a host without a card.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.models.vgg16 import VGG16
from semantic_pyramid_for_image_generation_torch.ops.cuda.attention import (
    pooled_kv_attention,
)
from semantic_pyramid_for_image_generation_torch.scripts import (
    finalblock_bench as fb,
    inputconv_bwd_bench as ic,
    profile_step as ps,
    s2d_stem_bench as s2d,
)

REPO = Path(__file__).resolve().parents[1]


def _load_jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[f"jax_{name}"] = module
    spec.loader.exec_module(module)
    return module


jax_fb = _load_jax_script("finalblock_bench")
jax_ic = _load_jax_script("inputconv_bwd_bench")
jax_s2d = _load_jax_script("s2d_stem_bench")


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def oihw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(3, 2, 0, 1)))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------- finalblock --

@pytest.mark.parametrize("size", [2, 5, 16, 128])
def test_stats_weights_match_jax(size):
    for got, want in zip(fb._stats_weights(size), jax_fb._stats_weights(size)):
        assert got.shape == want.shape
        assert rel(got, want) <= 1e-5


@pytest.mark.parametrize("hw", [(4, 4), (6, 10), (16, 8)])
def test_upsample2_stats_match_jax(hw):
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(
        np.float32)
    want = jax_fb.upsample2_stats(jnp.asarray(x))
    got = fb.upsample2_stats(nchw(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert rel(g.numpy(), w) <= 1e-5


def _chain_inputs(seed: int, hw=(6, 10), c: int = 4):
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, *hw, c)).astype(np.float32)
    kernel = (0.3 * r.standard_normal((3, 3, c, c))).astype(np.float32)
    scale = r.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (0.1 * r.standard_normal(c)).astype(np.float32)
    return x, kernel, scale, bias


@pytest.mark.parametrize("chain", ["current", "folded"])
def test_chain_loss_and_grads_match_jax(chain):
    x, kernel, scale, bias = _chain_inputs(2)
    fn = getattr(jax_fb, f"chain_{chain}")
    args = tuple(map(jnp.asarray, (x, kernel, scale, bias)))
    want_loss = jax.jit(fn)(*args)
    want_gx, want_gk = jax.jit(jax.grad(fn, argnums=(0, 1)))(*args)
    loss, gx, gk = fb.loss_and_grads(fb.CHAINS[chain], nchw(x), oihw(kernel),
                                     torch.from_numpy(scale),
                                     torch.from_numpy(bias))
    assert rel(loss.numpy(), want_loss) <= 1e-4
    assert rel(gx.permute(0, 2, 3, 1).numpy(), want_gx) <= 1e-4
    assert rel(gk.permute(2, 3, 1, 0).numpy(), want_gk) <= 1e-4


@pytest.mark.parametrize("hw", [(6, 10), (16, 16)])
def test_chains_agree(hw):
    x, kernel, scale, bias = _chain_inputs(3, hw)
    args = (nchw(x), oihw(kernel), torch.from_numpy(scale),
            torch.from_numpy(bias))
    current = fb.loss_and_grads(fb.chain_current, *args)
    folded = fb.loss_and_grads(fb.chain_folded, *args)
    assert fb.CHAIN_TOLERANCE == 1e-4
    for got, want in zip(folded, current):
        assert rel(got.numpy(), want.numpy()) <= fb.CHAIN_TOLERANCE


# -------------------------------------------------------------- inputconv --

JAX_VARIANTS = {"pad_inside": "pad_inside(current)", "no_pad": "no_pad(3ch)",
                "pad_outside": "pad_outside(8ch weights-only slice)",
                "custom": "custom_vjp(split bwd convs)"}


def _conv_inputs(seed: int, hw=(12, 10)):
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, *hw, 3)).astype(np.float32)
    k = r.standard_normal((3, 3, 3, 8)).astype(np.float32)
    return x, k


@pytest.mark.parametrize("variant", list(ic.VARIANTS))
def test_inputconv_variant_matches_jax_and_no_pad(variant):
    variants, _ = jax_ic.make_variants(1, jnp.float32)
    jax_fn = variants[JAX_VARIANTS[variant]][0]
    x, k = _conv_inputs(4)
    if variant == "pad_outside":
        x = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, 5)))

    def loss(x, k):
        return jnp.mean(jax_fn(x, k).astype(jnp.float32) ** 2)

    want_gx, want_gk = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(k))
    gx, gk = ic.grads(ic.VARIANTS[variant], nchw(x), oihw(k))
    assert ic.TOLERANCE == {"grad_x": 1e-5, "grad_k": 1e-4}
    assert rel(gx.permute(0, 2, 3, 1).numpy(), want_gx) <= ic.TOLERANCE[
        "grad_x"]
    assert rel(gk.permute(2, 3, 1, 0).numpy(), want_gk) <= ic.TOLERANCE[
        "grad_k"]
    base_gx, base_gk = ic.grads(ic.no_pad, nchw(x[..., :3]), oihw(k))
    assert rel(gx[:, :3].numpy(), base_gx.numpy()) <= ic.TOLERANCE["grad_x"]
    assert rel(gk.numpy(), base_gk.numpy()) <= ic.TOLERANCE["grad_k"]
    if variant == "pad_outside":
        assert not gx[:, 3:].any()


# -------------------------------------------------------------------- s2d --

def test_s2d_pieces_match_jax_bitwise():
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 8, 12, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        s2d.space_to_depth(nchw(x)).numpy(),
        np.asarray(jax_s2d.space_to_depth(jnp.asarray(x))).transpose(
            0, 3, 1, 2))
    k = r.standard_normal((3, 3, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        s2d.scatter_kernel_s2d(oihw(k)).numpy(),
        np.asarray(jax_s2d.scatter_kernel_s2d(jnp.asarray(k))).transpose(
            3, 2, 0, 1))
    out = r.standard_normal((1, 129, 129, 4 * 2)).astype(np.float32)
    np.testing.assert_array_equal(
        s2d.depth_from_phases(nchw(out), 2).numpy(),
        np.asarray(jax_s2d.depth_from_phases(jnp.asarray(out), 2)).transpose(
            0, 3, 1, 2))


@pytest.mark.parametrize("hw", [(256, 256), (12, 20)])
@pytest.mark.parametrize("variant", list(s2d.VARIANTS))
def test_s2d_variant_matches_direct_conv(variant, hw):
    batch = 1 if hw == (256, 256) else 2
    x, k = _conv_inputs(6, hw)
    x, k = nchw(x[:batch]), oihw(np.concatenate([k] * 8, axis=3))
    fn = s2d.VARIANTS[variant]
    with torch.no_grad():
        want = ic.no_pad(x, k)
        err = ((fn(x, k) - want).abs().max() / want.abs().max()).item()
    assert s2d.TOLERANCE == 1e-6
    assert err <= s2d.TOLERANCE
    gx, gk = ic.grads(fn, x, k)
    want_gx, want_gk = ic.grads(ic.no_pad, x, k)
    assert rel(gx.numpy(), want_gx.numpy()) <= ic.TOLERANCE["grad_x"]
    assert rel(gk.numpy(), want_gk.numpy()) <= ic.TOLERANCE["grad_k"]


# ----------------------------------------------------------- profile_step --

BF16 = "c10::BFloat16"
CONV_DIMS = [[2, 3, 8, 8], [4, 3, 3, 3], [], [], [], [], []]
CONV_TYPES = [BF16, BF16, "", "ScalarList", "ScalarList", "ScalarList",
              "Scalar"]
CONV_CONCRETE = ["", "", "", "[1, 1]", "[1, 1]", "[1, 1]", "1"]
MM_DIMS = [[256, 4096], [4096, 256]]  # bound by its FLOPs in float32


def _cpu_op(name, ext, ts, dur, dims=(), types=(), concrete=()):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": 1,
            "ts": ts, "dur": dur,
            "args": {"External id": ext, "Input Dims": list(dims),
                     "Input type": list(types),
                     "Concrete Inputs": list(concrete)}}


def _device(name, ext, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"External id": ext,
                                           "correlation": ext + 1000}}


def _step_events(t0: float, ext: int) -> list:
    """One step: a bf16 conv (2 kernels, 50 us), the upsample kernel (20),
    a host-to-device memcpy (25), an in-place add (10), a float32 mm (5)."""
    return [
        _cpu_op("aten::conv2d", ext, t0, 100, CONV_DIMS, CONV_TYPES,
                CONV_CONCRETE),
        _cpu_op("aten::convolution", ext + 1, t0 + 1, 98,
                CONV_DIMS + [[], []], CONV_TYPES + ["ScalarList", "Scalar"],
                CONV_CONCRETE[:6] + ["False", "[0, 0]", "1"]),
        _cpu_op("aten::cudnn_convolution", ext + 2, t0 + 2, 90),
        _device("sm90_xmma_fprop_implicit_gemm_bf16", ext + 2, t0 + 10, 40),
        _device("void nchwToNhwcKernel<__nv_bfloat16>", ext + 2, t0 + 5, 10),
        _cpu_op("spig::upsample_2x", ext + 3, t0 + 200, 50, [[2, 4, 8, 8]],
                [BF16]),
        _device("void upsample_2x_kernel<__nv_bfloat16>(...)", ext + 3,
                t0 + 210, 20),
        _cpu_op("aten::copy_", ext + 4, t0 + 300, 30,
                [[2, 4, 8, 8], [2, 4, 8, 8], []], ["float", "float",
                                                    "Scalar"]),
        _device("Memcpy HtoD (Pageable -> Device)", ext + 4, t0 + 305, 25,
                "gpu_memcpy"),
        _cpu_op("aten::add_", ext + 5, t0 + 400, 20,
                [[2, 4, 8, 8], [2, 4, 8, 8], []], ["float", "float",
                                                    "Scalar"]),
        _device("void at::native::vectorized_elementwise_kernel<4>", ext + 5,
                t0 + 405, 10),
        _cpu_op("aten::mm", ext + 6, t0 + 500, 20, MM_DIMS,
                ["float", "float"]),
        _device("nvjet_sm90_tst_128x256", ext + 6, t0 + 505, 5),
    ]


@pytest.fixture
def trace_dir(tmp_path):
    events = _step_events(0, 10) + _step_events(1000, 30)
    (tmp_path / ps.TRACE).write_text(json.dumps({"traceEvents": events}))
    (tmp_path / ps.CAPTURE).write_text(json.dumps({
        "batch": 2, "dtype": "bfloat16", "steps": 2, "warmup": 1,
        "wall_us_per_step": 1000.0, "unprofiled_us_per_step": 500.0,
        "step_flops": 989e12 * 1e-3 * 0.25,
        "card": "NVIDIA H100 80GB HBM3, 700.00 W"}))
    return tmp_path


def test_analyze_a_hand_written_trace(trace_dir):
    report = ps.analyze(str(trace_dir), 2)
    assert report["total_device_us_per_step"] == 110.0
    assert report["category_shares_pct"] == {
        "convolution": 45.45, "copies": 22.73, "port kernels": 18.18,
        "elementwise": 9.09, "matmul": 4.55}
    assert [r["op"] for r in report["top_ops"]] == [
        "aten::conv2d", "aten::copy_", "spig::upsample_2x", "aten::add_",
        "aten::mm"]
    rows = {r["op"]: r for r in report["top_ops"]}
    assert rows["aten::conv2d"]["kernels"] == [
        {"kernel": "sm90_xmma_fprop_implicit_gemm_bf16",
         "launched_by": "aten::cudnn_convolution", "us_per_step": 40.0},
        {"kernel": "void nchwToNhwcKernel<__nv_bfloat16>",
         "launched_by": "aten::cudnn_convolution", "us_per_step": 10.0}]
    assert {op: r["n"] for op, r in rows.items()} == dict.fromkeys(rows, 2)
    assert rows["aten::conv2d"]["self_us_per_step"] == 50.0
    assert rows["aten::conv2d"]["bound_by"] == "bytes"
    assert rows["aten::mm"]["bound_by"] == "operations"
    assert rows["spig::upsample_2x"]["bound_by"] == "bytes"
    assert rows["spig::upsample_2x"]["gflops_per_s"] is None
    flops = 2 * 256 * 256 * 4096  # an instance; 2 in 2 x 5 us
    assert rows["aten::mm"]["gflops_per_s"] == round(flops / 5e-6 / 1e9, 1)
    # conv: 2 x 4 x 8 x 8 outputs of 27 multiply-adds, 2 instances in 100 us
    assert rows["aten::conv2d"]["gflops_per_s"] == round(
        2 * 2 * 4 * 64 * 27 * 2 / 100e-6 / 1e9, 1)
    # upsample: in (2, 4, 8, 8) bf16 read, 4x that written
    assert rows["spig::upsample_2x"]["mem_bw_gib_s"] == round(
        2 * 5 * 512 * 2 / 40e-6 / 2 ** 30, 1)
    assert report["launches_per_step"] == {
        "pooled_kv_attention": 0, "max_pool_2x2": 0, "upsample_2x": 1,
        "max_pool_2x2_backward": 0, "upsample_2x_backward": 0,
        "batch_norm_stats": 0, "batch_norm_apply": 0,
        "batch_norm_backward_sums": 0, "batch_norm_backward_dx": 0}
    formatting = {(r["op"], r["within"]) for r in
                  report["data_formatting_ops"]}
    assert formatting == {
        ("void nchwToNhwcKernel<__nv_bfloat16>", "aten::conv2d"),
        ("Memcpy HtoD (Pageable -> Device)", "aten::copy_")}
    assert [r["op"] for r in report["elementwise_ops"]] == ["aten::add_"]
    assert report["top_launchers"][0] == {
        "launched_by": "aten::cudnn_convolution", "within": "aten::conv2d",
        "us_per_step": 50.0, "share_pct": 45.45}
    # busy: per step the conv's two kernels overlap (t0+5..t0+50, 45 us),
    # then 20 + 25 + 10 + 5 us; 2 steps of a 1000 us wall
    assert report["device_busy_pct"] == round(100 * 2 * 105 / 2000, 2)
    assert report["step_mfu_pct"] == 25.0
    assert report["step_mfu_pct_unprofiled"] == 50.0


def test_analyze_counts_each_batch_norm_kernel_by_its_name(tmp_path):
    """Kernels 6-9 by their device names, as a trace demangles them; Adam's
    `multi_tensor_apply_kernel` is no batch-norm apply."""
    names = {
        "batch_norm_stats": "void spig::(anonymous namespace)::"
                            "batch_norm_stats_kernel<8>(...)",
        "batch_norm_apply": "void spig::(anonymous namespace)::"
                            "batch_norm_apply_kernel<8>(...)",
        "batch_norm_backward_sums": "void spig::(anonymous namespace)::"
                                    "batch_norm_backward_sums_kernel<1>(...)",
        "batch_norm_backward_dx": "void spig::(anonymous namespace)::"
                                  "batch_norm_backward_dx_kernel<8>(...)",
    }
    events = []
    for step in range(2):
        t0, ext = 1000 * step, 100 * step
        for i, (op, kernel) in enumerate(names.items()):
            events += [_cpu_op(f"spig::{op}", ext + i, t0 + 100 * i, 50),
                       _device(kernel, ext + i, t0 + 100 * i + 10, 20)]
        events += [_cpu_op("aten::_foreach_add_", ext + 9, t0 + 600, 50),
                   _device("void at::native::(anonymous namespace)::"
                           "multi_tensor_apply_kernel<...>", ext + 9,
                           t0 + 610, 20)]
    (tmp_path / ps.TRACE).write_text(json.dumps({"traceEvents": events}))
    (tmp_path / ps.CAPTURE).write_text(json.dumps({
        "batch": 2, "dtype": "bfloat16", "steps": 2, "warmup": 1,
        "wall_us_per_step": 1000.0, "unprofiled_us_per_step": 500.0,
        "step_flops": 1e9, "card": "NVIDIA H100 80GB HBM3, 700.00 W"}))
    report = ps.analyze(str(tmp_path), 2)
    assert report["launches_per_step"] == {
        **dict.fromkeys(ps.PORT_KERNELS, 0), **dict.fromkeys(names, 1)}
    assert report["category_shares_pct"]["port kernels"] == 80.0


def test_analyze_only_rereads_a_kept_log_dir(trace_dir, capsys):
    assert ps.main(["--log_dir", str(trace_dir), "--analyze_only",
                    "--steps", "2", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(ps.analyze(str(trace_dir), 2)))


REPORT_KEYS = {"total_device_us_per_step", "category_shares_pct", "top_ops",
               "data_formatting_ops", "elementwise_ops", "top_launchers",
               "wall_us_per_step",
               "device_busy_pct", "launches_per_step", "step_flops",
               "step_mfu_pct", "unprofiled_us_per_step",
               "step_mfu_pct_unprofiled", "batch", "dtype", "card"}


def test_profile_step_at_tiny_on_the_cpu(tmp_path):
    args = ps.build_parser().parse_args(
        ["--device", "cpu", "--batch", "2", "--steps", "1", "--warmup", "1"])
    ps.capture(args, str(tmp_path),
               PyramidGANConfig(compute_dtype="float32").tiny())
    report = ps.analyze(str(tmp_path), args.steps)
    assert set(report) == REPORT_KEYS
    assert report["card"] == "cpu" and report["batch"] == 2
    assert report["step_flops"] > 0 and report["wall_us_per_step"] > 0
    # no card: no device time, no share of a card's peak
    assert report["total_device_us_per_step"] == 0.0
    assert report["step_mfu_pct"] is None
    assert set(report["launches_per_step"]) == set(ps.PORT_KERNELS)


def test_count_flops_of_the_tiny_vgg_forward():
    config = PyramidGANConfig(compute_dtype="float32").tiny()
    vgg = VGG16(config).eval()
    images = torch.zeros((2, 3, config.image_size, config.image_size))
    want, cin, size = 0, 3, config.image_size
    for item in [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512,
                 512, "M", 512, 512, 512, "M"]:
        if item == "M":
            size //= 2
            continue
        cout = item // config.vgg_width_factor
        want += 2 * 2 * size * size * cout * cin * 9
        cin = cout
    fc = 4096 // config.vgg_width_factor
    for fan_in, fan_out in ((cin * 7 * 7, fc), (fc, fc),
                            (fc, config.num_classes)):
        want += 2 * 2 * fan_in * fan_out
    with torch.no_grad():
        assert ps.count_flops(lambda: vgg(images)) == want


def test_count_flops_of_the_attention_kernel():
    q, k, v = (torch.zeros(s) for s in ((2, 64, 8), (2, 16, 8), (2, 16, 32)))
    assert ps.count_flops(lambda: pooled_kv_attention(q, k, v)) == (
        2 * 2 * 64 * 16 * (8 + 32))


# ---------------------------------------------------------------- devices --

@pytest.mark.parametrize("module", [fb, ic, s2d, ps],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_scripts_refuse_cuda_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(["--device", "cuda", "--batch", "1", "--iters", "1"]
                    if module is not ps else ["--device", "cuda"])
