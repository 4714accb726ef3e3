#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # from the repository root

Phases; any failure raises and exits non-zero, before the result lines:

 1. CUDA check; the card's name and power limit (nvidia-smi).
 2. Build the CUDA kernels from csrc/ with nvcc for sm_90a; build seconds and
    the ptxas register / spill lines.
 3. Each kernel against its plain PyTorch version at the main path's shapes
    (bucket 16), in bf16 and fp32: max error beside its tolerance, kernel ms,
    plain ms, the library yardstick's ms and the bound (bytes at 3.35 TB/s,
    flops at 67 TFLOP/s fp32 or 989 TFLOP/s bf16; NVIDIA's H100 SXM data).
    Times are medians of 21 CUDA-event windows of 10 back-to-back launches,
    queued behind a spin kernel so host overhead stays out.
 4. End-to-end reference: a tiny-width model on the card (kernels) against
    the same model on the CPU (plain versions), fp32 and bf16.
 5. The main path: a full-width (PyramidGANConfig() defaults) random-init
    model from a seed, served through GenerateService at the array level with
    buckets (1, 16): three requests in bf16, then in fp32. Launch counters are
    reset before this phase; each request must move them by the expected
    counts (per G forward: attention +1, upsample +11, max pool +1 for the
    attention KV; per VGG forward: max pool +5).
 6. torch.profiler over single warm requests per bucket and dtype: device
    time by kernel, the kernels' share, the device's busy share.
 7. The `kernels` JSON line, the card line again, and last the device line.

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


# ---------------------------------------------------------------- phase 3 --


def attention_sites(dtype):
    """Kernel 1 on one bucket-16 G forward: q (B,1024,32), k (B,256,32),
    v (B,256,128)."""
    return [((BATCH, 1024, 32), (BATCH, 256, 32), (BATCH, 256, 128))]


def pool_sites(dtype):
    """Kernel 2: the 5 VGG pools and the attention KV pool (NCHW shapes)."""
    return [(BATCH, 64, 256, 256), (BATCH, 128, 128, 128), (BATCH, 256, 64, 64),
            (BATCH, 512, 32, 32), (BATCH, 512, 16, 16), (BATCH, 256, 32, 32)]


def upsample_sites(dtype):
    """Kernel 3: main and residual upsample of the 5 blocks, then the final
    block. In bf16 the residual runs up2(conv1x1(x)), so it upsamples the
    block's output channels."""
    blocks = [(512, 512, 4), (512, 512, 8), (512, 256, 16), (256, 128, 32),
              (128, 64, 64)]
    sites = []
    for cin, cout, hw in blocks:
        sites.append((BATCH, cin, hw, hw))
        sites.append((BATCH, cin if dtype == torch.float32 else cout, hw, hw))
    sites.append((BATCH, 64, 128, 128))
    return sites


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

    def ulps(dtype, ref, n):
        """n bf16 ulps of the largest |ref| (fp32 callers pass their own)."""
        return n * 2.0 ** -7 * ref.abs().max().item()

    specs = {
        "pooled_kv_attention": dict(
            source="semantic_pyramid_for_image_generation_torch/csrc/attention.cu",
            replaces="semantic_pyramid_for_image_generation_tpu/ops/pallas/attention.py:58",
            sites=attention_sites,
            make=lambda s, dt: [randn(x, dt) for x in s],
            kernel=attention.pooled_kv_attention,
            plain=attention.pooled_kv_attention_plain,
            library=lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, scale=1.0),
            flops=lambda q, k, v: 2 * q.shape[0] * q.shape[1] * k.shape[1]
            * (q.shape[2] + v.shape[2]),
            out_bytes=lambda q, k, v: q.shape[0] * q.shape[1] * v.shape[2]
            * v.element_size(),
            # fp32: only the summation order differs, but logits of ~25 carry
            # ~1e-6 relative error into exp; bf16: the plain version rounds p
            # to bf16 before p @ v and both round the output
            tol=lambda dt, ref: 1e-4 if dt == torch.float32 else ulps(dt, ref, 2),
        ),
        "max_pool_2x2": dict(
            source="semantic_pyramid_for_image_generation_torch/csrc/max_pool.cu",
            replaces="semantic_pyramid_for_image_generation_tpu/ops/pallas/pool.py:123",
            sites=pool_sites,
            make=lambda s, dt: [randn(s, dt, cl)],
            kernel=pool.max_pool_2x2,
            plain=pool.max_pool_2x2_plain,
            library=lambda x: F.max_pool2d(x, 2),
            flops=lambda x: 3 * x.numel() // 4,
            out_bytes=lambda x: x.numel() // 4 * x.element_size(),
            tol=lambda dt, ref: 0.0,  # bitwise
        ),
        "upsample_2x": dict(
            source="semantic_pyramid_for_image_generation_torch/csrc/upsample.cu",
            replaces="semantic_pyramid_for_image_generation_tpu/ops/pallas/resize.py:99",
            sites=upsample_sites,
            make=lambda s, dt: [randn(s, dt, cl)],
            kernel=resize.upsample_2x,
            plain=resize.upsample_2x_plain,
            library=lambda x: F.interpolate(x, scale_factor=2, mode="bilinear",
                                            align_corners=True),
            flops=lambda x: 6 * 4 * x.numel(),
            out_bytes=lambda x: 4 * x.numel() * x.element_size(),
            # fp32: a few ulps (FMA contraction, zero terms of the matrix
            # form); bf16: the plain version rounds between passes
            tol=lambda dt, ref: 1e-5 if dt == torch.float32 else ulps(dt, ref, 2),
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
            for site in spec["sites"](dtype):
                args = spec["make"](site, dtype)
                got = spec["kernel"](*args)
                want = spec["plain"](*args)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = spec["tol"](dtype, want.float())
                ok = (torch.equal(got, want) if tol == 0.0 else err <= tol)
                print(f"  {name} {str(dtype)[6:]} {tuple(site)}: "
                      f"max_abs_err {err:.3g} (tol {tol:.3g}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version at {site} in {dtype}")
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["ms"] += time_ms(lambda: spec["kernel"](*args))
                row["plain_ms"] += time_ms(lambda: spec["plain"](*args))
                row["library_ms"] += time_ms(lambda: spec["library"](*args))
                t_bytes = (nbytes(*args) + spec["out_bytes"](*args)) \
                    / HBM_BYTES_PER_S * 1e3
                t_flops = spec["flops"](*args) / PEAK_FLOPS[dtype] * 1e3
                row["bound_ms"] += max(t_bytes, t_flops)
                bytes_s += t_bytes
                flops_s += t_flops
            row["bound_by"] = "bytes" if bytes_s >= flops_s else "operations"
            row["sites"] = len(spec["sites"](dtype))
            print(f"  {name} {str(dtype)[6:]} over {row['sites']} sites: "
                  f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                  f"library {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
            if dtype == torch.bfloat16:
                entry.update(row, dtype="bfloat16")
            else:
                entry["float32"] = row
        results[name] = entry
    return results


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
                        "max_pool_2x2": 5 * vgg_forwards + 1}
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


KERNEL_NAMES = ("attention_kernel", "max_pool_2x2_kernel", "upsample_2x_kernel")


def profile_requests(device) -> None:
    """torch.profiler over one warm request per bucket and dtype;
    device time by kernel name, the port's kernels' share, and the device's
    busy share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    g16, v16, g32, v32 = build_full_width_models(device)
    image = request_image()
    for g, v in ((g16, v16), (g32, v32)):
        service = service_for(g, v)
        for level, n, class_id in ((0, 1, None), (3, BATCH, 42)):
            run = lambda: service.generate_arrays(  # noqa: E731
                image, level=level, class_id=class_id, num_samples=n)
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                wall_ms = (time.perf_counter() - t0) * 1e3
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_ms = sum(e.device_time_total for e in kernels) / 1e3
            by_name: dict = {}
            for e in kernels:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
            ours = sum(t for name, t in by_name.items()
                       if any(k in name for k in KERNEL_NAMES))
            print(f"  profile {g.config.compute_dtype} batch {n}: wall "
                  f"{wall_ms:.2f} ms, device busy {busy_ms:.3f} ms "
                  f"({100 * busy_ms / wall_ms:.1f}%), {len(kernels)} device "
                  f"ops, port kernels {ours:.3f} ms "
                  f"({100 * ours / max(busy_ms, 1e-9):.1f}% of busy)")
            for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
                print(f"      {t:8.3f} ms  {name[:100]}")


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
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("   ", line.strip())

    print("[3] kernels against their plain versions (bucket 16)", flush=True)
    kernels = check_kernels(device)

    print("[4] tiny end-to-end reference", flush=True)
    check_tiny_reference(device)

    print("[5] main path: full-width serving, bf16 then fp32", flush=True)
    launches = drive_main_path(device)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} was never launched on the main path")
        kernels[name]["launches"] = count

    print("[6] profile of single requests", flush=True)
    profile_requests(device)

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
