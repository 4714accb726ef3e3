#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): the serving path,
the fused G/D train step, the Trainer and the VGG-16 fine-tune.

    python3 chip_smoke.py            # from the repository root

Phases; any failure raises and exits non-zero, before the result lines:

 1. CUDA check; the card's name and power limit (nvidia-smi).
 2. Build the CUDA kernels from csrc/ with nvcc for sm_90a; build seconds and
    the ptxas register / spill lines of the kernels redesigned for Hopper.
    The SASS of the library (cuobjdump -sass) must hold tensor-core
    instructions (HMMA or HGMMA) in every bf16 attention instantiation.
 3. Each kernel against its plain PyTorch version at its main path's shapes
    (batch 16), in bf16 and fp32: per site, max error beside its tolerance,
    kernel us and its share of the bound; summed over the sites, kernel ms,
    plain ms, the library yardstick's ms and the bound (bytes at 3.35 TB/s,
    flops at 67 TFLOP/s fp32 or 989 TFLOP/s bf16; NVIDIA's H100 SXM data).
    The three forwards at the serving sites, the two backwards at the train
    step's sites (max-pool backward bitwise, on tie-heavy inputs); the
    attention Function's plain backward is timed beside them. Times are
    medians of 21 CUDA-event windows of 10 back-to-back launches, queued
    behind a spin kernel so host overhead stays out. First, what PyTorch's
    own fill and copy reach over 128 MiB: the rate a kernel that only
    streams bytes can expect on this card. Last, the three forwards at the
    Trainer's generate batches (32: validation, 49: the grid), checked
    against their plain versions, not timed.
 4. End-to-end references: a tiny-width model on the card (kernels) against
    the same model on the CPU (plain versions): generate in fp32 and bf16,
    and two fp32 train steps (metrics, parameters, u/v, BN statistics).
 5. The serving path: a full-width (PyramidGANConfig() defaults) random-init
    model from a seed, served through GenerateService at the array level
    with buckets (1, 16): three requests in bf16, then in fp32. Launch
    counters are reset before it; each request must move them by the
    expected counts (per G forward: attention +1, upsample +11, max pool +1
    for the attention KV; per VGG forward: max pool +5; no backward).
 6. The train path: the fused train step at full width, random init from
    the seed, on synthetic batches of 16 with training masks, in bf16 then
    fp32: 1 warm-up and 5 timed steps each (ms/step, images/s, peak memory),
    then one bf16 step at batch 64 (peak memory). Launch counters are reset
    before it; each step must move them by attention 5, upsample 22, max
    pool 30, max-pool backward 14, upsample backward 11.
 7. The Trainer path: `Trainer.train` at full width in bf16 (random init
    from the seed, u/v advanced as in phase 6) on 4 in-memory synthetic
    batches of 16, validating every 32 samples on 2 batches of 32: an FID
    and a sweep grid after steps 2 and 4, the epoch-end checkpoint and grid.
    Launch counters are reset before it and must move by 4 train steps plus
    7 generates (1 attention, 11 upsample, 6 max pool each). The FID from the
    host (float64 sqrtm) and the device (float32 eigh) reductions of the
    same moments; the 49-row grid as an array (a PNG only where PIL
    imports); a fresh Trainer auto-resumes from checkpoint_000.pt with G, D,
    Adam and step bitwise equal, then both take one step on one pinned
    batch. Timings beside the card line: Trainer images/s beside phase 6's
    bare step, validate split into generate, Inception and statistics,
    checkpoint save and restore seconds and bytes.
 8. The VGG-16 fine-tune path (cli/vgg16_finetune.py): (a) a full-width
    VGG16 (135,755,949 parameters), random init from the CLI's seed, takes
    1 warm-up and 5 timed fine-tune steps in bf16 at batch 256 (256x256,
    synthetic batches on the card), one eval step, then 1 warm-up and 3
    timed steps in fp32 at batch 64; launch counters are reset before it and
    each step must move them by 5 max pool and 5 max-pool backward, the eval
    step by 5 max pool, nothing else (ms/step, images/s, peak memory, and
    the layout of the gradients autograd hands Kernel 4). (b) Kernels 2 and
    4 at the five batch-256 sites in bf16 and fp32, bitwise against their
    plain versions in chunks of 32 images on tie-heavy inputs, timed beside
    the bound and `F.max_pool2d` / `max_pool2d_with_indices_backward`. (c)
    The CLI at full width on a JPEG ImageFolder tree in a temporary
    directory (a 4-class head): the host's cores, the loader's images/s over
    the batches of 256 after its first, and the same loads on threads and
    on processes; 2 epochs of 2 steps with --export_pt; a --resume restores
    weights, Adam state, epoch and best_prec1 bitwise, one more pinned step
    from each agrees, the export loads strictly and vgg16_infer runs on it;
    the bytes written. (d) The serving-artifact writer: phase 5's bf16 modules written
    with buckets (1, 16), read back, two requests equal to the in-memory
    service's. The phase's seconds.
 9. torch.profiler over single warm requests per bucket and dtype, over
    one warm train step at batch 16 per dtype, and over one warm bf16
    fine-tune step at batch 256: device time by kernel and by kind of op,
    the kernels' share, the device's busy share.
10. The `kernels` JSON line (launches from the train path; the serving,
    Trainer and fine-tune paths' as `serving_launches`, `trainer_launches`,
    `finetune_launches`; Kernels 2 and 4 at the fine-tune's sites as
    `finetune_batch256`), the card line again, and last the device line.

Imports torch, numpy and the port only; needs one card and no network.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
BATCH = 16
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
DTYPES = (torch.bfloat16, torch.float32)  # bf16 is the serving default
G_PARAMETERS = 29_967_047  # the Generator at full width
D_PARAMETERS = 16_820_994  # the Discriminator at full width
LR = 1e-5  # the reference's learning rate
TRAIN_STEPS = 6  # 1 warm-up + 5 timed
TRAIN_LAUNCHES = {  # per train step (chip_smoke phase 6)
    "pooled_kv_attention": 5, "upsample_2x": 22, "max_pool_2x2": 30,
    "max_pool_2x2_backward": 14, "upsample_2x_backward": 11}
GENERATE_LAUNCHES = {  # per eval generate (VGG pyramid, then G)
    "pooled_kv_attention": 1, "upsample_2x": 11, "max_pool_2x2": 6,
    "max_pool_2x2_backward": 0, "upsample_2x_backward": 0}
EVAL_BATCHES = (2 * BATCH, 49)  # validation generates, the 7x7 grid
TRAINER_STEPS = 4  # phase 7: training batches of BATCH
VALIDATION_BATCHES = 2  # phase 7: validation batches of 2 * BATCH


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 21, inner: int = 10) -> float:
    """Median device ms of one call: CUDA events around `inner` back-to-back
    launches queued behind a spin kernel, so launch overhead is hidden."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------- phase 2 --

# the kernels redesigned for Hopper: their ptxas lines are printed, and the
# bf16 attention kernel must run on the tensor cores
REDESIGNED = ("attention_mma_kernel", "attention_fp32_kernel",
              "upsample_2x_kernel", "upsample_2x_backward_kernel")
TENSOR_CORE_OPS = ("HMMA", "HGMMA")


def short_name(symbol: str, kernel: str) -> str:
    """A kernel's name and mangled template arguments (ILi2ELi16) from its
    mangled symbol."""
    return kernel + symbol.split(kernel, 1)[1].split("EE")[0]


def print_ptxas_lines(log: str) -> None:
    """The ptxas register and spill lines of the redesigned kernels, one line
    per instantiation: 'name: Used N registers ...; N bytes spill ...'."""
    name, parts = None, []
    for line in log.splitlines() + ["ptxas info    : Compiling entry function"]:
        if "Compiling entry function" in line:
            if name is not None and parts:
                print(f"    {name}: {'; '.join(parts)}")
            name = next((short_name(line, k) for k in REDESIGNED if k in line),
                        None)
            parts = []
        elif name is not None and ("registers" in line or "spill" in line):
            parts.append(line.split(":", 1)[-1].strip())


def cuobjdump() -> str:
    """cuobjdump from the CUDA toolkit, else the copy in Triton's package."""
    import importlib.util
    import os
    import shutil

    found = shutil.which("cuobjdump")
    if found is None and os.path.exists("/usr/local/cuda/bin/cuobjdump"):
        found = "/usr/local/cuda/bin/cuobjdump"
    spec = importlib.util.find_spec("triton")
    if found is None and spec is not None and spec.origin is not None:
        candidate = os.path.join(os.path.dirname(spec.origin), "backends",
                                 "nvidia", "bin", "cuobjdump")
        found = candidate if os.path.exists(candidate) else None
    if found is None:
        raise RuntimeError("cuobjdump not found (CUDA toolkit or triton)")
    return found


def check_sass(library_path) -> None:
    """Dump the library's SASS; fail unless every instantiation of the bf16
    attention kernel holds tensor-core instructions (HMMA or HGMMA)."""
    sass = subprocess.run([cuobjdump(), "-sass", str(library_path)],
                          check=True, capture_output=True, text=True).stdout
    functions: dict = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            functions[name] = {}
        elif name is not None:
            for op in TENSOR_CORE_OPS:
                if op + "." in line or op + " " in line:
                    functions[name][op] = functions[name].get(op, 0) + 1
    mma = {n: ops for n, ops in functions.items()
           if "attention_mma_kernel" in n}
    for n, ops in mma.items():
        print(f"    SASS {short_name(n, 'attention_mma_kernel')}: {ops}")
    if not mma or not all(ops for ops in mma.values()):
        raise AssertionError("the bf16 attention kernel holds no HMMA/HGMMA "
                             "instructions")
    print(f"    SASS check: {len(mma)} bf16 attention instantiations, all "
          f"on the tensor cores ({len(functions)} functions dumped)",
          flush=True)


# ---------------------------------------------------------------- phase 3 --


# A site is (shapes, dtype): the kernel's input shapes at one call of its
# main path and the dtype it runs in there.

def attention_sites(dtype, batch=BATCH):
    """Kernel 1 on one G forward: q (B,1024,32), k (B,256,32),
    v (B,256,128)."""
    return [(((batch, 1024, 32), (batch, 256, 32), (batch, 256, 128)), dtype)]


def vgg_pools(batch=BATCH):
    return [(batch, 64, 256, 256), (batch, 128, 128, 128),
            (batch, 256, 64, 64), (batch, 512, 32, 32), (batch, 512, 16, 16)]


def kv_pool(batch=BATCH):
    return (batch, 256, 32, 32)  # the attention KV pool of G and of D


def pool_sites(dtype, batch=BATCH):
    """Kernel 2: the 5 VGG pools and the attention KV pool (NCHW shapes)."""
    return [(shape, dtype) for shape in vgg_pools(batch) + [kv_pool(batch)]]


def upsample_shapes(dtype, batch=BATCH):
    """Kernel 3's inputs: main and residual upsample of the 5 blocks, then
    the final block. In bf16 the residual runs up2(conv1x1(x)), so it
    upsamples the block's output channels."""
    blocks = [(512, 512, 4), (512, 512, 8), (512, 256, 16), (256, 128, 32),
              (128, 64, 64)]
    shapes = []
    for cin, cout, hw in blocks:
        shapes.append((batch, cin, hw, hw))
        shapes.append((batch, cin if dtype == torch.float32 else cout, hw, hw))
    shapes.append((batch, 64, 128, 128))
    return shapes


def upsample_sites(dtype, batch=BATCH):
    return [(shape, dtype) for shape in upsample_shapes(dtype, batch)]


def pool_backward_sites(dtype):
    """Kernel 4 in one train step: the 5 VGG pools on the fakes (compute
    dtype), the 5 loss pools on the fake features (fp32), the KV pool of D
    on real and fake (D phase) and on fake (G phase), and of G (G phase)."""
    loss = [(b, c, h // 2, w // 2) for b, c, h, w in vgg_pools()]
    return ([(shape, dtype) for shape in vgg_pools()]
            + [(shape, torch.float32) for shape in loss]
            + [(kv_pool(), dtype)] * 4)


def upsample_backward_sites(dtype):
    """Kernel 5 in one train step: the gradients of the 11 upsample outputs
    of the G phase's forward, (B, C, 2H, 2W)."""
    return [((b, c, 2 * h, 2 * w), dtype)
            for b, c, h, w in upsample_shapes(dtype)]


def tie_heavy(shape, dtype, g):
    """Post-ReLU values quantized to quarters in [0, 1.5]: most 2x2 windows
    hold ties, as ReLU zeros and saturated activations make them."""
    x = torch.randn(shape, generator=g, device=g.device).relu()
    x = torch.clamp(torch.round(x * 4) / 4, max=1.5)
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def memory_ceilings(device) -> None:
    """TB/s of `fill_` (writes only) and `copy_` (reads and writes as many)
    over 128 MiB outputs, beside the 3.35 TB/s that the bounds assume."""
    y = torch.empty(2 ** 25, device=device)
    x = torch.ones_like(y)
    for what, fn, moved in (("fill", lambda: y.fill_(1), nbytes(y)),
                            ("copy", lambda: y.copy_(x), 2 * nbytes(y))):
        rate = moved / (time_ms(fn) * 1e-3)
        print(f"  {what} over 128 MiB: {rate / 1e12:.3f} TB/s "
              f"({100 * rate / HBM_BYTES_PER_S:.0f}% of 3.35 TB/s)", flush=True)


def check_kernels(device) -> dict:
    from semantic_pyramid_for_image_generation_torch.ops.cuda import (
        attention,
        pool,
        resize,
    )

    g = torch.Generator(device).manual_seed(SEED)
    cl = torch.channels_last

    def randn(shape, dtype, memory_format=torch.contiguous_format):
        return torch.randn(shape, generator=g, device=device).to(
            dtype).contiguous(memory_format=memory_format)

    def ulps(ref, n):
        """n bf16 ulps of the largest |ref| (fp32 callers pass their own)."""
        return n * 2.0 ** -7 * ref.abs().max().item()

    def pool_backward_args(shape, dtype):
        b, c, h, w = shape
        return [tie_heavy(shape, dtype, g),
                randn((b, c, h // 2, w // 2), dtype, cl)]

    def max_pool_library(x, grad):
        _, indices = F.max_pool2d(x, 2, return_indices=True)
        return lambda: torch.ops.aten.max_pool2d_with_indices_backward(
            grad, x, [2, 2], [2, 2], [0, 0], [1, 1], False, indices)

    def upsample_library(grad):
        b, c, h, w = grad.shape
        return lambda: torch.ops.aten.upsample_bilinear2d_backward(
            grad, [h, w], [b, c, h // 2, w // 2], True)

    pallas = "semantic_pyramid_for_image_generation_tpu/ops/pallas/"
    csrc = "semantic_pyramid_for_image_generation_torch/csrc/"
    specs = {
        "pooled_kv_attention": dict(
            source=csrc + "attention.cu", replaces=pallas + "attention.py:58",
            sites=attention_sites,
            make=lambda s, dt: [randn(x, dt) for x in s],
            kernel=attention.pooled_kv_attention,
            plain=attention.pooled_kv_attention_plain,
            library=lambda q, k, v: lambda: F.scaled_dot_product_attention(
                q, k, v, scale=1.0),
            flops=lambda q, k, v: 2 * q.shape[0] * q.shape[1] * k.shape[1]
            * (q.shape[2] + v.shape[2]),
            out_bytes=lambda q, k, v: q.shape[0] * q.shape[1] * v.shape[2]
            * v.element_size(),
            # fp32: only the summation order differs, but logits of ~25 carry
            # ~1e-6 relative error into exp; bf16: the plain version rounds p
            # to bf16 before p @ v and both round the output
            tol=lambda dt, ref: 1e-4 if dt == torch.float32 else ulps(ref, 2),
        ),
        "max_pool_2x2": dict(
            source=csrc + "max_pool.cu", replaces=pallas + "pool.py:123",
            sites=pool_sites,
            make=lambda s, dt: [randn(s, dt, cl)],
            kernel=pool.max_pool_2x2,
            plain=pool.max_pool_2x2_plain,
            library=lambda x: lambda: F.max_pool2d(x, 2),
            flops=lambda x: 3 * x.numel() // 4,
            out_bytes=lambda x: x.numel() // 4 * x.element_size(),
            tol=lambda dt, ref: 0.0,  # bitwise
        ),
        "upsample_2x": dict(
            source=csrc + "upsample.cu", replaces=pallas + "resize.py:99",
            sites=upsample_sites,
            make=lambda s, dt: [randn(s, dt, cl)],
            kernel=resize.upsample_2x,
            plain=resize.upsample_2x_plain,
            library=lambda x: lambda: F.interpolate(
                x, scale_factor=2, mode="bilinear", align_corners=True),
            flops=lambda x: 6 * 4 * x.numel(),
            out_bytes=lambda x: 4 * x.numel() * x.element_size(),
            # fp32: a few ulps (FMA contraction, zero terms of the matrix
            # form); bf16: the plain version rounds between passes
            tol=lambda dt, ref: 1e-5 if dt == torch.float32 else ulps(ref, 2),
        ),
        "max_pool_2x2_backward": dict(
            source=csrc + "max_pool.cu", replaces=pallas + "pool.py:167",
            sites=pool_backward_sites,
            make=pool_backward_args,
            kernel=pool.max_pool_2x2_backward,
            plain=pool.max_pool_2x2_backward_plain,
            library=max_pool_library,
            # compares and selects of the recomputed forward, the routing
            flops=lambda x, grad: 10 * x.numel(),
            out_bytes=lambda x, grad: x.numel() * x.element_size(),
            tol=lambda dt, ref: 0.0,  # bitwise
        ),
        "upsample_2x_backward": dict(
            source=csrc + "upsample.cu", replaces=pallas + "resize.py:151",
            sites=upsample_backward_sites,
            make=lambda s, dt: [randn(s, dt, cl)],
            kernel=resize.upsample_2x_backward,
            plain=resize.upsample_2x_backward_plain,
            library=upsample_library,
            # ~9 weighted taps per input element, two flops each
            flops=lambda grad: 2 * 9 * grad.numel() // 4,
            out_bytes=lambda grad: grad.numel() // 4 * grad.element_size(),
            # fp32: summation order; bf16: the plain version rounds between
            # its two passes, the kernel once
            tol=lambda dt, ref: 1e-5 * max(1.0, ref.abs().max().item())
            if dt == torch.float32 else ulps(ref, 2),
        ),
    }

    results = {}
    for name, spec in specs.items():
        entry = {"name": name, "route": "cuda", "source": spec["source"],
                 "replaces": spec["replaces"]}
        for dtype in DTYPES:
            row = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "library_ms": 0.0, "bound_ms": 0.0}
            bytes_s = flops_s = 0.0
            sites = spec["sites"](dtype)
            for shape, site_dtype in sites:
                args = spec["make"](shape, site_dtype)
                got = spec["kernel"](*args)
                want = spec["plain"](*args)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = spec["tol"](site_dtype, want.float())
                ok = (torch.equal(got, want) if tol == 0.0 else err <= tol)
                site = (f"  {name} {str(site_dtype)[6:]} {tuple(shape)}: "
                        f"max_abs_err {err:.3g} (tol {tol:.3g})")
                if not ok:
                    print(site + " FAIL", flush=True)
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version at {shape} in {site_dtype}")
                ms = time_ms(lambda: spec["kernel"](*args))
                t_bytes = (nbytes(*args) + spec["out_bytes"](*args)) \
                    / HBM_BYTES_PER_S * 1e3
                t_flops = spec["flops"](*args) / PEAK_FLOPS[site_dtype] * 1e3
                bound = max(t_bytes, t_flops)
                print(f"{site} ok, {ms * 1e3:.1f} us, {100 * bound / ms:.0f}% "
                      f"of its bound", flush=True)
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["ms"] += ms
                row["plain_ms"] += time_ms(lambda: spec["plain"](*args))
                row["library_ms"] += time_ms(spec["library"](*args))
                row["bound_ms"] += bound
                bytes_s += t_bytes
                flops_s += t_flops
            row["bound_by"] = "bytes" if bytes_s >= flops_s else "operations"
            row["sites"] = len(sites)
            print(f"  {name} {str(dtype)[6:]} over {row['sites']} sites: "
                  f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                  f"library {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
            if dtype == torch.bfloat16:
                entry.update(row, dtype="bfloat16")
            else:
                entry["float32"] = row
        results[name] = entry
    # the Trainer's generates: validation at 2 x BATCH rows, the grid at 49;
    # checked against the plain versions, not timed
    for name in ("pooled_kv_attention", "max_pool_2x2", "upsample_2x"):
        spec = specs[name]
        for batch in EVAL_BATCHES:
            for dtype in DTYPES:
                worst, sites = 0.0, spec["sites"](dtype, batch)
                for shape, site_dtype in sites:
                    args = spec["make"](shape, site_dtype)
                    got = spec["kernel"](*args)
                    want = spec["plain"](*args)
                    err = (got.float() - want.float()).abs().max().item()
                    tol = spec["tol"](site_dtype, want.float())
                    if not (torch.equal(got, want) if tol == 0.0
                            else err <= tol):
                        raise AssertionError(
                            f"{name} disagrees with its plain version at "
                            f"{shape} in {site_dtype}")
                    worst = max(worst, err)
                print(f"  {name} {str(dtype)[6:]} batch {batch}, "
                      f"{len(sites)} sites: max_abs_err {worst:.3g} ok",
                      flush=True)
    time_attention_backward(device, results["pooled_kv_attention"])
    return results


def time_attention_backward(device, entry) -> None:
    """The attention Function's backward is plain PyTorch (the JAX package's
    `_bwd` is XLA einsums, not a Pallas kernel); its time at the train
    step's site, per call, is recorded beside Kernel 1 as
    `plain_backward_ms`."""
    from semantic_pyramid_for_image_generation_torch.ops.cuda.attention import (
        pooled_kv_attention_backward_plain,
    )

    g = torch.Generator(device).manual_seed(SEED)
    for dtype in DTYPES:
        (q, k, v), _ = attention_sites(dtype)[0]
        args = [torch.randn(s, generator=g, device=device).to(dtype)
                for s in (q, k, v, (q[0], q[1], v[2]))]
        ms = time_ms(lambda: pooled_kv_attention_backward_plain(*args))
        row = entry if dtype == torch.bfloat16 else entry["float32"]
        row["plain_backward_ms"] = ms
        print(f"  pooled_kv_attention plain backward {str(dtype)[6:]}: "
              f"{ms:.4f} ms", flush=True)


# ---------------------------------------------------------------- phase 4 --


def check_tiny_reference(device) -> None:
    """A tiny model on the card (CUDA kernels) against the same weights on the
    CPU (plain versions), on one small batch at levels 0, 3 and 6."""
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.data.masks import (
        MaskSchedule,
    )
    from semantic_pyramid_for_image_generation_torch.models import make_models
    from semantic_pyramid_for_image_generation_torch.models.layers import (
        advance_spectral_norm_,
    )
    from semantic_pyramid_for_image_generation_torch.train.step import (
        make_generate_fn,
    )

    rng = np.random.default_rng(SEED)
    images = rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    cfg0 = PyramidGANConfig().tiny()
    labels = np.eye(cfg0.num_classes, dtype=np.float32)[[1, 9]]
    noise = rng.standard_normal((2, cfg0.latent_dim)).astype(np.float32)
    schedule = MaskSchedule(cfg0)
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 0.1)):
        cfg = dataclasses.replace(cfg0, compute_dtype=dtype)
        cpu_g, cpu_v = make_models(cfg, torch.device("cpu"),
                                   torch.Generator().manual_seed(SEED))
        advance_spectral_norm_(cpu_g, 10)
        gpu_g, gpu_v = make_models(cfg, device)
        gpu_g.load_state_dict(cpu_g.state_dict())
        gpu_v.load_state_dict(cpu_v.state_dict())
        runs = {}
        for dev, fn in ((torch.device("cpu"), make_generate_fn(cpu_g, cpu_v)),
                        (device, make_generate_fn(gpu_g, gpu_v))):
            outs = []
            for level in (0, 3, 6):
                masks = schedule.batch([schedule.inference_masks(level)] * 2)
                t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
                outs.append(fn(t(images), [t(m) for m in masks], t(labels),
                               t(noise)).float().cpu())
            runs[dev.type] = torch.stack(outs)
        err = (runs["cuda"] - runs["cpu"]).abs().max().item()
        print(f"  tiny generate {dtype}: card vs CPU plain max_abs_err "
              f"{err:.3g} (tol {tol})", flush=True)
        if not (torch.isfinite(runs["cuda"]).all() and err <= tol):
            raise AssertionError(f"tiny end-to-end {dtype} disagrees")



def check_tiny_train_step(device) -> None:
    """Two fp32 train steps of a tiny model on the card (CUDA kernels)
    against the same state, batches and noise on the CPU (plain versions),
    held as tests/test_torch_train_step.py holds the port against JAX:
    metrics rtol 2e-3 / atol 2e-5; parameters within 1e-2 * lr plus one fp32
    ulp on all but 0.1% of the elements (Adam turns gradients at the fp32
    noise floor into +-lr steps) and within 4 * lr on every element; u/v
    1e-4; BN statistics 1e-6 + 3e-4 relative (the final BN's mean 2e-5)."""
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.data.synthetic import (
        synthetic_batch,
    )
    from semantic_pyramid_for_image_generation_torch.models.layers import (
        advance_spectral_norm_,
    )
    from semantic_pyramid_for_image_generation_torch.train.state import (
        init_train_state,
    )
    from semantic_pyramid_for_image_generation_torch.train.step import (
        batch_to_device,
        make_train_step,
    )

    cfg = PyramidGANConfig().tiny()
    cpu = torch.device("cpu")
    rng = np.random.default_rng(SEED)
    batches = []
    for _ in range(2):
        batch = synthetic_batch(cfg, 2, rng)
        for key in ("noise_d", "noise_g"):
            batch[key] = rng.standard_normal((2, cfg.latent_dim)).astype(
                np.float32)
        batches.append(batch)
    states = {"cpu": init_train_state(cfg, cpu, lr=LR, seed=SEED)}
    for net in (states["cpu"].generator, states["cpu"].discriminator):
        advance_spectral_norm_(net, 10)
    states["cuda"] = init_train_state(cfg, device, lr=LR)
    for net in ("generator", "discriminator", "vgg"):
        getattr(states["cuda"], net).load_state_dict(
            getattr(states["cpu"], net).state_dict())
    step = make_train_step()
    metrics = {"cpu": [], "cuda": []}
    for batch in batches:
        for key, dev in (("cpu", cpu), ("cuda", device)):
            _, m = step(states[key], batch_to_device(batch, dev))
            metrics[key].append({k: float(v) for k, v in m.items()})
    for i, (got, want) in enumerate(zip(metrics["cuda"], metrics["cpu"])):
        for k, w in want.items():
            if not abs(got[k] - w) <= 2e-5 + 2e-3 * abs(w):
                raise AssertionError(f"tiny train step {i} {k}: card "
                                     f"{got[k]} vs CPU {w}")
    worst = {}
    for net in ("generator", "discriminator"):
        got = {k: v.cpu() for k, v in getattr(states["cuda"], net)
               .state_dict().items()}
        want = getattr(states["cpu"], net).state_dict()
        off = total = 0
        for key, w in want.items():
            err = (got[key] - w).abs()
            if key.endswith(("weight_u", "weight_v")):
                tol = torch.full_like(w, 1e-4)
            elif key.endswith(("running_mean", "running_var")):
                atol = 2e-5 if key == "final_block.1.running_mean" else 1e-6
                tol = atol + 3e-4 * w.abs()
            elif key.endswith("num_batches_tracked"):
                continue
            else:
                if err.max() > 4 * LR:
                    raise AssertionError(f"tiny train {net} {key}: "
                                         f"{err.max().item():.3g} > 4 lr")
                bad = err > 1e-2 * LR + 2.0 ** -22 * w.abs()
                off += int(bad.sum())
                total += err.numel()
                continue
            if bool((err > tol).any()):
                raise AssertionError(f"tiny train {net} {key}: max |card - "
                                     f"CPU| {err.max().item():.3g}")
        worst[net] = (off, total)
        if off > 1e-3 * total:
            raise AssertionError(f"tiny train {net}: {off} of {total} "
                                 f"parameter elements off")
    print(f"  tiny train step fp32, 2 steps: card vs CPU plain metrics ok "
          f"(step 2 {metrics['cuda'][1]}); parameter elements off by more "
          f"than 1% of a step: {worst}", flush=True)


# ---------------------------------------------------------------- phase 5 --


REQUESTS = [  # (level, num_samples, class_id); None = fc8 auto class
    (0, 1, None),
    (3, 16, 42),
    (6, 4, None),
]


def build_full_width_models(device):
    """(bf16 G, bf16 VGG, fp32 G, fp32 VGG): one random init from SEED at
    PyramidGANConfig() widths, the same weights in both compute dtypes."""
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.models import make_models
    from semantic_pyramid_for_image_generation_torch.models.layers import (
        advance_spectral_norm_,
    )

    start = time.perf_counter()
    cfg16 = PyramidGANConfig(compute_dtype="bfloat16")
    g16, v16 = make_models(cfg16, device, torch.Generator(device).manual_seed(SEED))
    # sigma from 10 power iterations, as after training steps (from u/v
    # drawn at random, sigma is far below the spectral norm)
    advance_spectral_norm_(g16, 10)
    g32, v32 = make_models(dataclasses.replace(cfg16, compute_dtype="float32"),
                           device)
    g32.load_state_dict(g16.state_dict())
    v32.load_state_dict(v16.state_dict())
    n_params = sum(p.numel() for p in g16.parameters())
    print(f"  full-width model (G {n_params:,} parameters) built in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    if n_params != G_PARAMETERS:
        raise AssertionError(f"G has {n_params} parameters")
    return g16, v16, g32, v32


def service_for(generator, vgg):
    from semantic_pyramid_for_image_generation_torch.serving.export import (
        ServingArtifact,
    )
    from semantic_pyramid_for_image_generation_torch.serving.server import (
        GenerateService,
    )

    return GenerateService(ServingArtifact.from_modules(generator, vgg,
                                                        (1, BATCH)))


def request_image() -> np.ndarray:
    return np.random.default_rng(SEED).uniform(-1, 1, (256, 256, 3)).astype(
        np.float32)


def drive_main_path(device) -> dict:
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels

    g16, v16, g32, v32 = build_full_width_models(device)
    image = request_image()
    kernels.reset_launch_counts()
    for g, v in ((g16, v16), (g32, v32)):
        service = service_for(g, v)
        dtype = g.config.compute_dtype
        for level, n, class_id in REQUESTS:
            times = []
            for rep in range(6):  # 1 warm-up + 5 timed
                before = kernels.launch_counts()
                t0 = time.perf_counter()
                out = service.generate_arrays(image, level=level,
                                              class_id=class_id,
                                              num_samples=n, seed=rep)
                times.append((time.perf_counter() - t0) * 1e3)
                after = kernels.launch_counts()
                delta = {k: after[k] - before[k] for k in after}
                vgg_forwards = 1 + (class_id is None)
                want = {"pooled_kv_attention": 1, "upsample_2x": 11,
                        "max_pool_2x2": 5 * vgg_forwards + 1,
                        "max_pool_2x2_backward": 0, "upsample_2x_backward": 0}
                if delta != want:
                    raise AssertionError(f"launches {delta}, expected {want}")
                fakes = out["fakes"]
                if fakes.shape != (n, 256, 256, 3):
                    raise AssertionError(f"output shape {fakes.shape}")
                if not np.isfinite(fakes).all():
                    raise AssertionError("non-finite output")
                if np.abs(fakes).max() > 1.0:
                    raise AssertionError("output outside [-1, 1]")
            print(f"  {dtype} level {level} num_samples {n} bucket "
                  f"{out['bucket']} class {out['class_id']}: "
                  f"{statistics.median(times[1:]):.2f} ms/request "
                  f"(first {times[0]:.1f} ms), launches {delta}, output "
                  f"std {fakes.std():.3g}", flush=True)
    return kernels.launch_counts()


# ---------------------------------------------------------------- phase 6 --


def full_width_train_states(device):
    """(bf16 state, fp32 state): one random init from SEED at
    PyramidGANConfig() widths, u/v advanced 10 power iterations, the same
    weights in both compute dtypes."""
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.models.layers import (
        advance_spectral_norm_,
    )
    from semantic_pyramid_for_image_generation_torch.train.state import (
        init_train_state,
        param_count,
    )

    start = time.perf_counter()
    cfg16 = PyramidGANConfig(compute_dtype="bfloat16")
    s16 = init_train_state(cfg16, device, lr=LR, seed=SEED)
    for net in (s16.generator, s16.discriminator):
        advance_spectral_norm_(net, 10)
    s32 = init_train_state(dataclasses.replace(cfg16, compute_dtype="float32"),
                           device, lr=LR)
    for net in ("generator", "discriminator", "vgg"):
        getattr(s32, net).load_state_dict(getattr(s16, net).state_dict())
    counts = (param_count(s16.generator), param_count(s16.discriminator))
    print(f"  full-width train state (G {counts[0]:,}, D {counts[1]:,} "
          f"parameters) built in {time.perf_counter() - start:.1f} s",
          flush=True)
    if counts != (G_PARAMETERS, D_PARAMETERS):
        raise AssertionError(f"parameter counts {counts}")
    return s16, s32


def train_batches(config, batch, n, device):
    """`n` synthetic batches (images, labels, training masks) from SEED,
    made in bulk before any timing and moved to the card."""
    from semantic_pyramid_for_image_generation_torch.data.synthetic import (
        synthetic_batch,
    )
    from semantic_pyramid_for_image_generation_torch.train.step import (
        batch_to_device,
    )

    rng = np.random.default_rng(SEED)
    return [batch_to_device(synthetic_batch(config, batch, rng), device)
            for _ in range(n)]


def drive_train_path(device):
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
    from semantic_pyramid_for_image_generation_torch.train.step import (
        make_train_step,
    )

    s16, s32 = full_width_train_states(device)
    step = make_train_step()
    rng = torch.Generator(device).manual_seed(SEED)
    results = {}
    kernels.reset_launch_counts()
    for state in (s16, s32):
        dtype = state.generator.config.compute_dtype
        batches = train_batches(state.generator.config, BATCH, TRAIN_STEPS,
                                device)
        g0 = state.generator.final_block[3].weight_orig.detach().clone()
        d0 = state.discriminator.layers[0].main_block[0].weight_orig.detach(
            ).clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for batch in batches:
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            _, metrics = step(state, batch, rng)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            after = kernels.launch_counts()
            delta = {k: after[k] - before[k] for k in after}
            if delta != TRAIN_LAUNCHES:
                raise AssertionError(f"train step launches {delta}, expected "
                                     f"{TRAIN_LAUNCHES}")
            values = {k: float(v) for k, v in metrics.items()}
            if not all(np.isfinite(v) for v in values.values()):
                raise AssertionError(f"non-finite losses {values}")
        if torch.equal(state.generator.final_block[3].weight_orig, g0) or \
                torch.equal(state.discriminator.layers[0].main_block[0]
                            .weight_orig, d0):
            raise AssertionError("G or D parameters did not move")
        ms = statistics.median(times[1:])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        results[dtype] = {"ms_per_step": ms, "images_per_s": BATCH * 1e3 / ms,
                          "peak_gib": peak}
        print(f"  train {dtype} batch {BATCH}: {ms:.2f} ms/step median of "
              f"{len(times) - 1} (first {times[0]:.1f} ms; all "
              f"{[round(t, 2) for t in times]}), {BATCH * 1e3 / ms:.1f} "
              f"images/s, peak {peak:.2f} GiB, launches per step "
              f"{delta}, last losses {values}", flush=True)
    counts = kernels.launch_counts()
    del s32
    s16.g_optimizer.zero_grad(set_to_none=True)
    s16.d_optimizer.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (batch,) = train_batches(s16.generator.config, 4 * BATCH, 1, device)
    t0 = time.perf_counter()
    _, metrics = step(s16, batch, rng)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError("non-finite losses at batch 64")
    results["bfloat16_batch64"] = {"ms_first_step": ms, "peak_gib": peak}
    print(f"  train bfloat16 batch {4 * BATCH}: one step {ms:.1f} ms "
          f"(first at this shape), peak {peak:.2f} GiB", flush=True)
    return counts, results


# ---------------------------------------------------------------- phase 7 --


def trainer_state(device):
    """A full-width bf16 train state from SEED, u/v advanced 10 iterations
    (as in phase 6)."""
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.models.layers import (
        advance_spectral_norm_,
    )
    from semantic_pyramid_for_image_generation_torch.train.state import (
        init_train_state,
    )

    state = init_train_state(PyramidGANConfig(compute_dtype="bfloat16"),
                             device, lr=LR, seed=SEED)
    for net in (state.generator, state.discriminator):
        advance_spectral_norm_(net, 10)
    return state


class Clock:
    """Wall seconds of wrapped calls, keyed by the path of wrapped calls they
    run in ("validate/generate"); each call runs between two syncs, and the
    sync before waits for work queued earlier (it is not the call's)."""

    def __init__(self):
        self.seconds: dict = {}
        self._stack: list = []

    def wrap(self, label, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            self._stack.append(label)
            key = "/".join(self._stack)
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            finally:
                self._stack.pop()
            self.seconds[key] = self.seconds.get(key, 0.0) + \
                time.perf_counter() - t0
            return out
        return timed


def tree_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(tree_equal, a, b))
    return a == b


def drive_trainer_path(device, card: str, step_images_per_s: float) -> dict:
    """The Trainer at full width, bf16, batch 16: 4 steps, a validation (FID
    over 2 batches of 32) and sweep grid after steps 2 and 4, the epoch-end
    checkpoint and grid; then a fresh Trainer resumes from the checkpoint
    and both take one more step on the same pinned batch."""
    import glob
    import importlib.util
    import os
    import shutil
    import tempfile
    import warnings

    from semantic_pyramid_for_image_generation_torch.data.synthetic import (
        synthetic_batch,
    )
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
    from semantic_pyramid_for_image_generation_torch.train.loop import Trainer

    has_pil = importlib.util.find_spec("PIL") is not None
    state = trainer_state(device)
    config = state.generator.config
    rng = np.random.default_rng(SEED)
    train_set = [synthetic_batch(config, BATCH, rng)
                 for _ in range(TRAINER_STEPS)]
    val_set = [synthetic_batch(config, 2 * BATCH, rng, validation=True)
               for _ in range(VALIDATION_BATCHES)]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_trainer_")

    def trainer(state):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the random-init FID warning
            return Trainer(config, train_set, val_set, lr=LR, device=device,
                           save_data_path=workdir, seed=SEED, state=state,
                           allow_random_fid=True, write_grids=has_pil)

    first = trainer(state)
    clock = Clock()
    for name in ("validate", "inference", "save_checkpoint", "generate"):
        setattr(first, name, clock.wrap(name, getattr(first, name)))
    fid_eval = first.fid_evaluator
    reduce_moments = fid_eval.reduce_moments
    fid_eval.moments = clock.wrap("inception", fid_eval.moments)
    fid_eval.reduce_moments = clock.wrap("host statistics",
                                         fid_eval.reduce_moments)
    sec = clock.seconds
    laps = []  # host seconds of each train_step call, no sync added

    def lap(batch, train_step=first.train_step):
        t0 = time.perf_counter()
        out = train_step(batch)
        laps.append(time.perf_counter() - t0)
        return out

    first.train_step = lap
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    first.train(epochs=1, validate_after_n_iterations=2 * BATCH,
                validate_at_start=False, progress=False, log_every=50)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    # validation after every 2 * BATCH samples: after steps 2 and 4, each
    # followed by a grid; the epoch ends with one more grid
    validations = len(first.logger.metrics["iterations_fid"])
    if validations != TRAINER_STEPS // 2:
        raise AssertionError(f"{validations} validations")
    generates = validations * (VALIDATION_BATCHES + 1) + 1
    want = {k: TRAINER_STEPS * TRAIN_LAUNCHES[k] + generates * n
            for k, n in GENERATE_LAUNCHES.items()}
    print(f"  launches over Trainer.train: {counts} (expected {want}: "
          f"{TRAINER_STEPS} steps, {generates} generates: {validations} "
          f"validations of {VALIDATION_BATCHES} batches, "
          f"{validations + 1} grids)", flush=True)
    if counts != want:
        raise AssertionError(f"Trainer launches {counts}, expected {want}")

    metrics = first.logger.metrics
    losses = metrics["loss_generator"]
    if len(losses) != TRAINER_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"logged losses {losses}")
    n, totals = fid_eval.last_moments
    fid_host = metrics["fid"][0]
    t0 = time.perf_counter()
    fid_device = reduce_moments(n, totals, device_statistics=True)
    device_stats_s = time.perf_counter() - t0
    if not (np.isfinite(fid_host) and np.isfinite(fid_device)) or \
            n != VALIDATION_BATCHES * 2 * BATCH:
        raise AssertionError(f"FID host {fid_host} device {fid_device} n {n}")
    print(f"  FID (random-init Inception, {n} samples, not a standard FID): "
          f"host float64 sqrtm {fid_host:.6f}, device float32 eigh "
          f"{fid_device:.6f}, difference {fid_device - fid_host:.3g} "
          f"({(fid_device - fid_host) / fid_host:.3g} relative; the "
          f"covariances have rank <= {n - 1} of 2048)", flush=True)

    grid = first.last_grid
    if grid.shape != (49, 256, 256, 3) or not np.isfinite(grid).all():
        raise AssertionError(f"grid {grid.shape}")
    cells = grid.reshape(7, 7, -1)
    same = [c for c in range(6)
            if np.allclose(cells[:, c], cells[:, c + 1], atol=1e-3)]
    if same:
        raise AssertionError(f"grid columns {same} equal their neighbours")
    (ckpt,) = glob.glob(os.path.join(first.paths["models"], "checkpoint_*"))
    if os.path.basename(ckpt) != "checkpoint_000.pt":
        raise AssertionError(ckpt)
    pngs = glob.glob(os.path.join(first.paths["plots"], "*.png"))
    print(f"  grid (49, 256, 256, 3) finite, its 7 columns differ; PIL "
          f"{'present: ' + str(len(pngs)) + ' PNGs written' if has_pil else 'absent: no PNG written'}"
          f"; {os.path.basename(ckpt)} {os.path.getsize(ckpt):,} bytes; "
          f"{len(losses)} steps logged, last losses "
          f"{ {k: v[-1] for k, v in metrics.items() if k.startswith('loss')} }",
          flush=True)

    # resume: a fresh Trainer (a new init from the seed) adopts the checkpoint
    second = trainer(trainer_state(device))
    t0 = time.perf_counter()
    if not second.auto_resume(first.paths["models"]):
        raise AssertionError("auto_resume found no checkpoint")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for net in ("generator", "discriminator"):
        if not tree_equal(getattr(first.state, net).state_dict(),
                          getattr(second.state, net).state_dict()):
            raise AssertionError(f"resumed {net} differs")
        opt = f"{net[0]}_optimizer"
        if not tree_equal(getattr(first.state, opt).state_dict(),
                          getattr(second.state, opt).state_dict()):
            raise AssertionError(f"resumed {opt} differs")
    if second.state.step != first.state.step:
        raise AssertionError("resumed step differs")
    batch = dict(train_set[0])
    noise = np.random.default_rng(SEED + 1).standard_normal(
        (2, BATCH, config.latent_dim)).astype(np.float32)
    batch["noise_d"], batch["noise_g"] = noise
    after = []
    for t in (first, second):
        m = t.train_step(batch)
        after.append(({k: float(v) for k, v in m.items()},
                      {k: v.detach().float() for k, v in
                       t.state.generator.named_parameters()}))
    metric_err = max(abs(after[0][0][k] - after[1][0][k]) /
                     max(abs(after[0][0][k]), 1e-12) for k in after[0][0])
    param_err = max((after[0][1][k] - after[1][1][k]).abs().max().item()
                    for k in after[0][1])
    print(f"  resumed: G, D, both Adam states and the step equal bitwise; one "
          f"more step on a pinned batch in both: metrics max relative "
          f"difference {metric_err:.3g} (tolerance 1e-3), G parameters max "
          f"|difference| {param_err:.3g} (tolerance 2 lr = {2 * LR:g})",
          flush=True)
    # cuDNN's weight-gradient kernels may add in another order from run to
    # run; Adam moves each element by at most ~lr per step whatever its
    # gradient, so two runs differ by at most 2 lr; the losses are means of
    # O(1) terms and see D after its update
    if metric_err > 1e-3 or param_err > 2 * LR:
        raise AssertionError("the resumed step disagrees")

    steps_s = total_s - sum(sec[k] for k in
                            ("validate", "inference", "save_checkpoint"))
    images_per_s = TRAINER_STEPS * BATCH / steps_s
    print(f"  {card}: Trainer.train {total_s:.3f} s in all; its "
          f"{TRAINER_STEPS} steps {steps_s:.3f} s, {images_per_s:.1f} "
          f"images/s (the bare step, phase 6: {step_images_per_s:.1f}; "
          f"host ms per train_step call "
          f"{[round(1e3 * t, 2) for t in laps[:TRAINER_STEPS]]}); "
          f"validate {sec['validate']:.3f} s ({validations} x "
          f"{VALIDATION_BATCHES} batches of {2 * BATCH}): generate {sec['validate/generate']:.3f} "
          f"s, Inception {sec['validate/inception']:.3f} s, host statistics "
          f"(float64 sqrtm) {sec['validate/host statistics']:.3f} s; device "
          f"statistics (float32 eigh) {device_stats_s:.3f} s; "
          f"{validations + 1} grids "
          f"{sec['inference']:.3f} s (generate "
          f"{sec['inference/generate']:.3f} s); checkpoint save "
          f"{sec['save_checkpoint']:.3f} s, restore {restore_s:.3f} s, "
          f"{os.path.getsize(ckpt):,} bytes", flush=True)
    shutil.rmtree(workdir)
    return {"images_per_s": images_per_s, "counts": counts}


# ---------------------------------------------------------------- phase 8 --


FT_BATCH = 256  # the reference's fine-tune batch
FT_FP32_BATCH = 64
FT_STEPS = {"bfloat16": 6, "float32": 4}  # 1 warm-up, then timed steps
FT_LR = 1e-4  # the reference's fine-tune learning rate
FT_CLASSES = 365
VGG_PARAMETERS = 135_755_949  # VGG16 at full width, 365 classes
FT_CLI_CLASSES = 4  # the CLI check's image tree
FT_CLI_IMAGES = 320  # training JPEGs per class: 5 batches of 256
LOADER_WORKERS = 8  # ImageFolderLoader's threads, the CLI's --workers
FINETUNE_LAUNCHES = {  # per fine-tune step: the 5 VGG pools
    "pooled_kv_attention": 0, "upsample_2x": 0, "max_pool_2x2": 5,
    "max_pool_2x2_backward": 5, "upsample_2x_backward": 0}
EVAL_LAUNCHES = dict(FINETUNE_LAUNCHES, max_pool_2x2_backward=0)


def finetune_model(device, dtype: str, num_classes: int = FT_CLASSES):
    """A full-width VGG16 classifier, random init from the CLI's seed."""
    from semantic_pyramid_for_image_generation_torch.cli.vgg16_finetune import (
        build_model,
    )
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )

    return build_model(PyramidGANConfig(compute_dtype=dtype,
                                        num_classes=num_classes), device, None)


def finetune_batches(device, n: int, batch: int,
                     num_classes: int = FT_CLASSES) -> list:
    """`n` synthetic (images, labels) batches made on the card before any
    timing: images as the loader feeds them, the NCHW view of NHWC memory."""
    g = torch.Generator(device).manual_seed(SEED)
    return [(torch.randn((batch, 256, 256, 3), generator=g, device=device)
             .permute(0, 3, 1, 2),
             torch.randint(0, num_classes, (batch,), generator=g,
                           device=device)) for _ in range(n)]


def drive_finetune_path(device, card: str):
    """(a) Fine-tune steps of the full-width VGG16: bf16 at batch 256 (1
    warm-up, 5 timed, then one eval step), fp32 (TF32 off) at batch 64 (1
    warm-up, 3 timed). Each step must launch Kernels 2 and 4 five times
    each, the eval step Kernel 2 five times, and nothing else."""
    from semantic_pyramid_for_image_generation_torch.cli import (
        vgg16_finetune as ft,
    )
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
    from semantic_pyramid_for_image_generation_torch.ops.cuda import pool

    layouts = set()  # what autograd hands Kernel 4 as the output gradient
    backward = pool.max_pool_2x2_backward

    def probed_backward(x, g):
        layouts.add((tuple(g.shape), g.is_contiguous(
            memory_format=torch.channels_last)))
        return backward(x, g)

    pool.max_pool_2x2_backward = probed_backward
    results = {}
    kernels.reset_launch_counts()
    try:
        for dtype, batch in (("bfloat16", FT_BATCH), ("float32", FT_FP32_BATCH)):
            model = finetune_model(device, dtype)
            n_params = sum(p.numel() for p in model.parameters())
            if n_params != VGG_PARAMETERS:
                raise AssertionError(f"VGG16 has {n_params} parameters")
            first = next(model.parameters()).detach().clone()
            optimizer = ft.make_optimizer(model, FT_LR)
            step = ft.make_finetune_step(model, optimizer)
            batches = finetune_batches(device, FT_STEPS[dtype], batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for i, (x, y) in enumerate(batches):
                before = kernels.launch_counts()
                t0 = time.perf_counter()
                loss, top1 = step(x, y, ft.dropout_generator(0, i, device))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                after = kernels.launch_counts()
                delta = {k: after[k] - before[k] for k in after}
                if delta != FINETUNE_LAUNCHES:
                    raise AssertionError(f"fine-tune step launches {delta}, "
                                         f"expected {FINETUNE_LAUNCHES}")
                if not np.isfinite(float(loss)):
                    raise AssertionError(f"fine-tune loss {float(loss)}")
            if torch.equal(next(model.parameters()), first):
                raise AssertionError("the VGG16 parameters did not move")
            ms = statistics.median(times[1:])
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            row = {"batch": batch, "ms_per_step": ms,
                   "images_per_s": batch * 1e3 / ms, "peak_gib": peak,
                   "first_step_ms": times[0]}
            print(f"  fine-tune {dtype} batch {batch}: {ms:.2f} ms/step "
                  f"median of {len(times) - 1} (first {times[0]:.1f} ms; all "
                  f"{[round(t, 2) for t in times]}), {row['images_per_s']:.1f} "
                  f"images/s, peak {peak:.2f} GiB, launches per step {delta}, "
                  f"last loss {float(loss):.4f} top-1 {float(top1):.4f}",
                  flush=True)
            if dtype == "bfloat16":
                eval_step = ft.make_eval_step(model)
                x, y = batches[0]
                before = kernels.launch_counts()
                t0 = time.perf_counter()
                ce, t1, t5 = eval_step(x, y)
                torch.cuda.synchronize()
                row["eval_ms"] = (time.perf_counter() - t0) * 1e3
                after = kernels.launch_counts()
                delta = {k: after[k] - before[k] for k in after}
                if delta != EVAL_LAUNCHES:
                    raise AssertionError(f"eval launches {delta}, expected "
                                         f"{EVAL_LAUNCHES}")
                if ce.shape != (batch,) or not torch.isfinite(ce).all() or \
                        bool((t5 < t1).any()):
                    raise AssertionError("eval step outputs")
                print(f"  eval {dtype} batch {batch}: {row['eval_ms']:.2f} ms "
                      f"(first at this shape), launches {delta}, mean CE "
                      f"{float(ce.mean()):.4f}", flush=True)
            results[dtype] = row
            del model, optimizer, step, batches
            torch.cuda.empty_cache()
    finally:
        pool.max_pool_2x2_backward = backward
    counts = kernels.launch_counts()
    print(f"  {card}: launches over the fine-tune path {counts}; Kernel 4's "
          f"output gradients, (shape, channels_last): {sorted(layouts)}",
          flush=True)
    return counts, results


def check_finetune_pool_sites(device) -> dict:
    """(b) Kernels 2 and 4 at the five batch-256 sites in bf16 and fp32:
    bitwise against their plain versions run on chunks of 32 images, on
    tie-heavy inputs; kernel, library and plain times (the plain ones over
    the whole site, 3 single calls) beside the bound."""
    from semantic_pyramid_for_image_generation_torch.ops.cuda import pool

    g = torch.Generator(device).manual_seed(SEED)
    out: dict = {"max_pool_2x2": {}, "max_pool_2x2_backward": {}}
    for dtype in DTYPES:
        rows = {name: {"sites": 0, "max_abs_err": 0.0, "ms": 0.0,
                       "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                       "bytes_ms": 0.0, "ops_ms": 0.0} for name in out}
        for shape in vgg_pools(FT_BATCH):
            b, c, h, w = shape
            x = tie_heavy(shape, dtype, g)
            grad = torch.randn((b, c, h // 2, w // 2), generator=g,
                               device=device).to(dtype).contiguous(
                memory_format=torch.channels_last)
            y = pool.max_pool_2x2(x)
            gx = pool.max_pool_2x2_backward(x, grad)
            for i in range(0, b, 32):
                s = slice(i, i + 32)
                if not (torch.equal(y[s], pool.max_pool_2x2_plain(x[s])) and
                        torch.equal(gx[s], pool.max_pool_2x2_backward_plain(
                            x[s], grad[s]))):
                    raise AssertionError(f"Kernel 2 or 4 disagrees with its "
                                         f"plain version at {shape} {dtype}, "
                                         f"images {i}..{i + 31}")
            del y, gx
            _, indices = F.max_pool2d(x, 2, return_indices=True)
            calls = {
                "max_pool_2x2": (
                    lambda: pool.max_pool_2x2(x),
                    lambda: pool.max_pool_2x2_plain(x),
                    lambda: F.max_pool2d(x, 2),
                    nbytes(x) * 5 // 4, 3 * x.numel() // 4),
                "max_pool_2x2_backward": (
                    lambda: pool.max_pool_2x2_backward(x, grad),
                    lambda: pool.max_pool_2x2_backward_plain(x, grad),
                    lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                        grad, x, [2, 2], [2, 2], [0, 0], [1, 1], False,
                        indices),
                    nbytes(x) * 2 + nbytes(grad), 10 * x.numel()),
            }
            for name, (kernel, plain, library, moved, ops) in calls.items():
                row = rows[name]
                ms = time_ms(kernel, reps=7, inner=5)
                t_bytes = moved / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_FLOPS[dtype] * 1e3
                bound = max(t_bytes, t_ops)
                row["sites"] += 1
                row["ms"] += ms
                row["plain_ms"] += time_ms(plain, reps=3, inner=1)
                row["library_ms"] += time_ms(library, reps=7, inner=5)
                row["bound_ms"] += bound
                row["bytes_ms"] += t_bytes
                row["ops_ms"] += t_ops
                print(f"  {name} {str(dtype)[6:]} {shape}: bitwise in chunks "
                      f"of 32, {ms * 1e3:.1f} us, {100 * bound / ms:.0f}% of "
                      f"its bound", flush=True)
            del x, grad, indices
            torch.cuda.empty_cache()
        for name, row in rows.items():
            row["bound_by"] = ("bytes" if row.pop("bytes_ms") >= row.pop("ops_ms")
                               else "operations")
            print(f"  {name} {str(dtype)[6:]} over the {row['sites']} "
                  f"batch-{FT_BATCH} sites: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} "
                  f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
                  f"{100 * row['bound_ms'] / row['ms']:.0f}%)", flush=True)
            out[name][str(dtype)[6:]] = row
    return out


def time_image_loader(train_set) -> dict:
    """ImageFolderLoader's rate over a steady window (the batches after the
    first, whose wait holds the pool's start-up), the host's cores, and the
    same 256 loads (decode, float32, flip, normalize) spread over threads
    and over processes, each pool started before its clock: if the
    interpreter's lock holds the threads back, the processes run faster."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    from PIL import Image

    from semantic_pyramid_for_image_generation_torch.data.image_folder import (
        ImageFolderLoader,
    )

    out = {"cpu_count": os.cpu_count(),
           "usable_cores": len(os.sched_getaffinity(0))}
    loader = ImageFolderLoader(train_set, FT_BATCH, num_workers=LOADER_WORKERS)
    t0 = time.perf_counter()
    stamps = [time.perf_counter() for _ in loader]
    out["first_batch_s"] = stamps[0] - t0
    out["steady_images"] = (len(stamps) - 1) * FT_BATCH
    out["steady_images_per_s"] = out["steady_images"] / (stamps[-1] - stamps[0])
    # one thread: the whole load, and the JPEG decode alone
    k = 32
    t0 = time.perf_counter()
    for i in range(k):
        train_set.load(i, flip=True)
    out["one_thread_ms"] = (time.perf_counter() - t0) * 1e3 / k
    t0 = time.perf_counter()
    for path, _ in train_set.samples[k:2 * k]:
        with Image.open(path) as img:
            np.asarray(img.convert("RGB"))
    out["decode_ms"] = (time.perf_counter() - t0) * 1e3 / k
    jobs = list(range(FT_BATCH))
    flips = [True] * FT_BATCH
    pools = {"threads": ThreadPoolExecutor(LOADER_WORKERS),
             "processes": ProcessPoolExecutor(
                 LOADER_WORKERS, mp_context=multiprocessing.get_context("spawn"))}
    for kind, pool in pools.items():
        with pool:
            list(pool.map(train_set.load, jobs[:64], flips[:64]))
            t0 = time.perf_counter()
            list(pool.map(train_set.load, jobs, flips, chunksize=8))
            out[f"{kind}_images_per_s"] = FT_BATCH / (time.perf_counter() - t0)
    return out


def write_image_tree(root: str) -> None:
    """`<root>/{train,val}/class_<c>/<i>.jpg`: FT_CLI_CLASSES classes of
    FT_CLI_IMAGES training and 8 validation 256x256 JPEGs from SEED."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    jobs = []
    rng = np.random.default_rng(SEED)
    for split, n in (("train", FT_CLI_IMAGES), ("val", 8)):
        for c in range(FT_CLI_CLASSES):
            d = os.path.join(root, split, f"class_{c}")
            os.makedirs(d)
            for i in range(n):
                # smooth colour fields plus noise: JPEG-sized like photos
                base = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
                jobs.append((os.path.join(d, f"{i}.jpg"), base,
                             int(rng.integers(1 << 30))))

    def write(job):
        path, base, seed = job
        img = np.kron(base, np.ones((32, 32, 1), np.uint8)).astype(np.int16)
        img += np.random.default_rng(seed).integers(-20, 21, img.shape,
                                                    dtype=np.int16)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            path, quality=90)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))


def drive_finetune_cli(device, card: str) -> None:
    """(c) The CLI at full width on a JPEG ImageFolder tree (a 4-class
    head): time ImageFolderLoader (time_image_loader); 2 epochs of 2 steps
    with --export_pt; a --resume of the save_dir restores the state
    bitwise; one more pinned step from the finished run and from the
    resumed one agree; the export loads strictly and vgg16_infer runs it."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from semantic_pyramid_for_image_generation_torch.cli import (
        vgg16_finetune as ft,
    )
    from semantic_pyramid_for_image_generation_torch.cli import vgg16_infer
    from semantic_pyramid_for_image_generation_torch.data.image_folder import (
        ImageFolder,
    )
    from semantic_pyramid_for_image_generation_torch.models.vgg16 import VGG16

    workdir = tempfile.mkdtemp(prefix="chip_smoke_finetune_")
    try:
        data = os.path.join(workdir, "data")
        t0 = time.perf_counter()
        write_image_tree(data)
        tree_s = time.perf_counter() - t0
        rates = time_image_loader(ImageFolder(os.path.join(data, "train")))
        save_dir = os.path.join(workdir, "ckpt")
        export = os.path.join(workdir, "vgg16_export.pt")
        argv = ["--device", str(device), "--data", data, "--batch_size",
                str(FT_BATCH), "--workers", str(LOADER_WORKERS),
                "--num_classes", str(FT_CLI_CLASSES), "--load_vgg16", "",
                "--save_dir", save_dir, "--max_steps", "2", "--lr", str(FT_LR)]
        first = ft.FineTune(ft.build_parser().parse_args(
            argv + ["--epochs", "2", "--export_pt", export]))
        t0 = time.perf_counter()
        first.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        files = sorted(os.listdir(save_dir))
        if not {"latest_0.pt", "latest_1.pt", "best.pt"} <= set(files) or \
                not os.path.exists(export):
            raise AssertionError(f"checkpoints {files}, export "
                                 f"{os.path.exists(export)}")
        written = {f: os.path.getsize(os.path.join(save_dir, f)) for f in files}
        written["export"] = os.path.getsize(export)
        t0 = time.perf_counter()
        second = ft.FineTune(ft.build_parser().parse_args(
            argv + ["--epochs", "3", "--resume", save_dir]))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if (second.start_epoch, second.best_prec1) != (2, first.best_prec1):
            raise AssertionError(f"resumed at {second.start_epoch}, "
                                 f"{second.best_prec1}")
        if not tree_equal(first.model.state_dict(), second.model.state_dict()):
            raise AssertionError("the resumed weights differ")
        if not tree_equal(first.optimizer.state_dict(),
                          second.optimizer.state_dict()):
            raise AssertionError("the resumed Adam state differs")
        (x, y), = finetune_batches(device, 1, FT_BATCH, FT_CLI_CLASSES)
        after = []
        config = first.model.config
        for run in (first, second):
            masks = [m.to(device) for m in (
                torch.rand((FT_BATCH, config.vgg_fc7_dim), generator=torch
                           .Generator().manual_seed(SEED + j)) < 0.5
                for j in range(2))]
            loss, _ = run.train_step(x, y, dropout_masks=masks)
            after.append((float(loss), dict(run.model.named_parameters())))
        loss_err = abs(after[0][0] - after[1][0]) / abs(after[0][0])
        param_err = max((after[0][1][k] - after[1][1][k]).abs().max().item()
                        for k in after[0][1])
        # cuDNN's weight-gradient kernels may add in another order from run
        # to run: Adam moves each element by at most ~lr per step, so two
        # runs differ by at most 2 lr (phase 7's rule)
        if loss_err > 1e-3 or param_err > 2 * FT_LR:
            raise AssertionError(f"the pinned step disagrees: loss "
                                 f"{loss_err:.3g}, parameters {param_err:.3g}")
        best = torch.load(os.path.join(save_dir, "best.pt"),
                          map_location="cpu", weights_only=True)
        exported = torch.load(export, map_location="cpu", weights_only=True)
        if not tree_equal(best["state_dict"], exported):
            raise AssertionError("--export_pt differs from best.pt's weights")
        with torch.device("meta"):
            VGG16(config).load_state_dict(exported, strict=True, assign=True)
        del first, second, after, best, exported
        torch.cuda.empty_cache()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            vgg16_infer.main(["--device", str(device), "--data", data,
                              "--load_vgg16", export,
                              "--num_classes", str(FT_CLI_CLASSES)])
        argmax = [line for line in printed.getvalue().splitlines()
                  if line.startswith("predictions (argmax):")]
        if len(argmax) != 1:
            raise AssertionError(f"vgg16_infer printed {printed.getvalue()}")
        print(f"  {card}: image tree ({FT_CLI_CLASSES} classes, "
              f"{FT_CLI_CLASSES * FT_CLI_IMAGES} + {FT_CLI_CLASSES * 8} JPEGs)"
              f" written in {tree_s:.2f} s; host: {rates['cpu_count']} "
              f"cores, {rates['usable_cores']} usable; ImageFolderLoader, "
              f"{LOADER_WORKERS} threads: first batch after "
              f"{rates['first_batch_s']:.3f} s, then "
              f"{rates['steady_images_per_s']:.1f} images/s over the next "
              f"{rates['steady_images']} images; one thread "
              f"{rates['one_thread_ms']:.2f} ms per image, of which the JPEG "
              f"decode {rates['decode_ms']:.2f} ms; {FT_BATCH} loads on "
              f"{LOADER_WORKERS} threads {rates['threads_images_per_s']:.1f} "
              f"images/s, on {LOADER_WORKERS} processes "
              f"{rates['processes_images_per_s']:.1f} images/s; the CLI's 2 "
              f"epochs of 2 steps, "
              f"validation and checkpoints {run_s:.2f} s; bytes written "
              f"{written} ({sum(written.values()):,} in all); --resume "
              f"restored weights, Adam state, epoch and best_prec1 bitwise "
              f"in {restore_s:.2f} s; one more pinned step from each: loss "
              f"relative difference {loss_err:.3g} (tolerance 1e-3), "
              f"parameters max |difference| {param_err:.3g} (tolerance 2 lr "
              f"= {2 * FT_LR:g}); --export_pt equals best.pt's weights and "
              f"loads strictly; vgg16_infer: {argmax[0]}", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def check_artifact_round_trip(device, card: str) -> None:
    """(d) The serving-artifact writer at full width: write phase 5's bf16
    modules with buckets (1, 16), read the artifact back, and serve the
    same requests from both."""
    import os
    import shutil
    import tempfile

    from semantic_pyramid_for_image_generation_torch.serving.export import (
        ServingArtifact,
        save_artifact,
    )
    from semantic_pyramid_for_image_generation_torch.serving.server import (
        GenerateService,
    )

    g16, v16, _, _ = build_full_width_models(device)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_artifact_")
    try:
        t0 = time.perf_counter()
        save_artifact(g16, v16, workdir, (1, BATCH))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        read = GenerateService(ServingArtifact(workdir, device))
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        live = service_for(g16, v16)
        image = request_image()
        errs = []
        for level, n, class_id in REQUESTS[:2]:
            got = read.generate_arrays(image, level=level, class_id=class_id,
                                       num_samples=n, seed=1)
            want = live.generate_arrays(image, level=level, class_id=class_id,
                                        num_samples=n, seed=1)
            if got["class_id"] != want["class_id"]:
                raise AssertionError("the artifact classifies otherwise")
            errs.append(float(np.abs(got["fakes"] - want["fakes"]).max()))
        size = os.path.getsize(os.path.join(workdir, "weights.npz"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"  {card}: artifact written in {write_s:.2f} s (weights.npz "
          f"{size:,} bytes), read in {read_s:.2f} s; requests "
          f"{[r[:2] for r in REQUESTS[:2]]} from the artifact against the "
          f"in-memory modules: max |difference| {errs} (tolerance 0: the "
          f"same weights, the same kernels)", flush=True)
    if max(errs) > 0.0:
        raise AssertionError("the artifact's output differs")


KERNEL_NAMES = ("attention_mma_kernel", "attention_fp32_kernel",
                "max_pool_2x2_kernel", "upsample_2x_kernel",
                "max_pool_2x2_backward_kernel", "upsample_2x_backward_kernel")
# device op kinds by name, first match wins
OP_KINDS = (
    ("port kernels", KERNEL_NAMES),
    ("optimizer", ("multi_tensor_apply", "foreach", "fused_adam")),
    ("convolution", ("xmma", "conv", "cudnn", "fft", "FFT", "implicit_gemm",
                     "wgrad", "dgrad", "nhwcToNchw", "nchwToNhwc",
                     "pointwise_mult_and_sum_complex")),
    ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "Kernel2")),
    ("copies", ("Memcpy", "Memset", "copy_kernel", "direct_copy")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "index", "scatter",
                     "gather", "where")),
)


def profile_summary(label: str, run) -> None:
    """torch.profiler over one call of `run` (warm): wall time, device busy
    time and share, the port kernels' share of busy, the top 8 device ops."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device ops only: a GPU-side user annotation (Optimizer.step#Adam.step)
    # spans kernels counted on their own
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    ours = sum(t for name, t in by_name.items()
               if any(k in name for k in KERNEL_NAMES))
    print(f"  profile {label}: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(kernels)} "
          f"device ops, port kernels {ours:.3f} ms "
          f"({100 * ours / max(busy_ms, 1e-9):.1f}% of busy)")
    split: dict = {}
    for name, t in by_name.items():
        kind = next((k for k, keys in OP_KINDS if any(w in name for w in keys)),
                    "other")
        split[kind] = split.get(kind, 0.0) + t
    print("    by kind: " + ", ".join(
        f"{k} {t:.3f} ms" for k, t in sorted(split.items(), key=lambda x: -x[1])))
    for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
        print(f"      {t:8.3f} ms  {name[:100]}")


def profile_requests(device) -> None:
    """One warm request per bucket and dtype."""
    g16, v16, g32, v32 = build_full_width_models(device)
    image = request_image()
    for g, v in ((g16, v16), (g32, v32)):
        service = service_for(g, v)
        for level, n, class_id in ((0, 1, None), (3, BATCH, 42)):
            run = lambda: service.generate_arrays(  # noqa: E731
                image, level=level, class_id=class_id, num_samples=n)
            run()
            torch.cuda.synchronize()
            profile_summary(f"{g.config.compute_dtype} batch {n}", run)


def profile_train_step(device) -> None:
    """One warm train step at batch 16, bf16 then fp32."""
    from semantic_pyramid_for_image_generation_torch.train.step import (
        make_train_step,
    )

    step = make_train_step()
    for state in full_width_train_states(device):
        batches = train_batches(state.generator.config, BATCH, 2, device)
        step(state, batches[0])
        torch.cuda.synchronize()
        profile_summary(f"train step {state.generator.config.compute_dtype} "
                        f"batch {BATCH}", lambda: step(state, batches[1]))


def profile_finetune_step(device) -> None:
    """One warm fine-tune step of the full-width VGG16, bf16 at batch 256."""
    from semantic_pyramid_for_image_generation_torch.cli import (
        vgg16_finetune as ft,
    )

    model = finetune_model(device, "bfloat16")
    step = ft.make_finetune_step(model, ft.make_optimizer(model, FT_LR))
    batches = finetune_batches(device, 2, FT_BATCH)
    step(*batches[0], ft.dropout_generator(0, 0, device))
    torch.cuda.synchronize()
    profile_summary(f"fine-tune step bfloat16 batch {FT_BATCH}",
                    lambda: step(*batches[1],
                                 ft.dropout_generator(0, 1, device)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    from semantic_pyramid_for_image_generation_torch.ops.cuda import build

    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    start = time.perf_counter()
    build.library()
    print(f"[2] kernels built in {time.perf_counter() - start:.1f} s", flush=True)
    print_ptxas_lines(build.build_log())
    check_sass(build.build())

    print("[3] kernels against their plain versions (batch 16)", flush=True)
    memory_ceilings(device)
    kernels = check_kernels(device)

    print("[4] tiny end-to-end references", flush=True)
    check_tiny_reference(device)
    check_tiny_train_step(device)

    print("[5] serving path: full-width requests, bf16 then fp32", flush=True)
    serving = drive_main_path(device)
    for name, count in serving.items():
        backward = name.endswith("_backward")
        if (count == 0) != backward:
            raise AssertionError(f"serving launched {name} {count} times")
        kernels[name]["serving_launches"] = count

    print("[6] train path: full-width train steps, bf16 then fp32", flush=True)
    train, train_results = drive_train_path(device)
    for name, count in train.items():
        if count == 0:
            raise AssertionError(f"{name} was never launched on the train path")
        kernels[name]["launches"] = count

    print("[7] Trainer path: full-width bf16 Trainer.train, validation, grid, "
          "checkpoint and resume", flush=True)
    trainer = drive_trainer_path(device, card,
                                 train_results["bfloat16"]["images_per_s"])
    for name, count in trainer["counts"].items():
        kernels[name]["trainer_launches"] = count

    print("[8] VGG-16 fine-tune path: full-width steps (bf16 batch "
          f"{FT_BATCH}, fp32 batch {FT_FP32_BATCH}), Kernels 2 and 4 at its "
          "sites, the CLI, the artifact writer", flush=True)
    start = time.perf_counter()
    finetune, finetune_results = drive_finetune_path(device, card)
    steps = sum(FT_STEPS.values())
    want = {k: steps * n + EVAL_LAUNCHES[k] for k, n in
            FINETUNE_LAUNCHES.items()}
    if finetune != want:
        raise AssertionError(f"fine-tune path launches {finetune}, expected "
                             f"{want}")
    for name, count in finetune.items():
        kernels[name]["finetune_launches"] = count
    for name, rows in check_finetune_pool_sites(device).items():
        kernels[name]["finetune_batch256"] = rows
    drive_finetune_cli(device, card)
    check_artifact_round_trip(device, card)
    print(f"  phase 8 took {time.perf_counter() - start:.1f} s; bf16 batch "
          f"{FT_BATCH}: {finetune_results['bfloat16']['ms_per_step']:.2f} "
          f"ms/step", flush=True)

    print("[9] profiles of single requests, one train step and one "
          "fine-tune step", flush=True)
    profile_requests(device)
    profile_train_step(device)
    profile_finetune_step(device)

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
