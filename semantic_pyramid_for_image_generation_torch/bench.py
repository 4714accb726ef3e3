"""Throughput lanes of the PyTorch port on one card: the counterpart, lane
for lane, of the repository's root bench script for the JAX package.

    python -m semantic_pyramid_for_image_generation_torch.bench [--lane] \
        [--batch_size 128] [--steps 8] [--warmup 3] [--dtype bfloat16]

Each lane prints the card (`nvidia-smi` name and power limit; "cpu" with
--device cpu), then ONE JSON line {"metric", "value", "unit",
"vs_baseline"}. `vs_baseline` is the value over the V100 anchor of the JAX
lanes: the reference trained ~600k samples in ~24 h on one V100, ~6.94
images/s.

The lanes (the flags and defaults are the root script's, plus --device):
  * default: `--steps` full-width `make_train_step` steps queued with no
    host sync between them, then one `torch.cuda.synchronize()` and one
    scalar fetch; a first walk of the same length is the warm-up (the JAX
    lane packs the steps into one lax.scan and compiles it on its first
    walk). The device rate.
  * --per-step: `--warmup` steps, then `--steps` steps each followed by one
    scalar fetch.
  * --trainer: the real `Trainer.train` over a JPEG tree in a temporary
    directory (scripts/jpeg_tree.py): a warm-up epoch with its checkpoint,
    then a timed epoch with the save cadence at 10**9.
  * --host-pipeline: the loader's images/s over one epoch after one warm
    batch, then the fed step's rate (each batch copied to the card).
  * --serving: `make_generate_fn` on a validation batch, `--steps`
    generates with their own noise, then one sync; ms per call.
    `--batch_size 1` is the latency point.
  * --serving-artifact: the generate path exported for the device at
    `--batch_size` with external weights (serving/export.py::
    save_artifact), read back as a deployment reads it (serving/
    program.py::load_artifact, a ProgramArtifact), then `--steps` calls with
    noise drawn on the device per call and one sync; the program's KB.
  * --vgg-finetune: cli/vgg16_finetune.py's step (CE + Adam at lr 1e-4) on
    synthetic 256x256 batches, one fetch per step.
  * --check-pallas: Kernel 1's forward through its autograd Function with
    the port's backward, forward and all three input gradients at the
    generator's shape, against an fp32 oracle with TF32 off on copies
    upcast on the host, beside the plain attention; fp32 passes within
    1e-3, bf16 within 2x the plain attention's error + 1e-2. Exits 1 on
    FAIL.

Every lane runs full width at PyramidGANConfig() unless --channel_factor /
--vgg_width_factor shrink it (CPU runs only). On a CUDA device the kernels
run; `--no-pallas` is refused, as the port has no other route on the card.
`--device cuda` without a card raises before anything is built.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from semantic_pyramid_for_image_generation_torch.config import PyramidGANConfig
from semantic_pyramid_for_image_generation_torch.data.places365 import (
    Places365,
    Places365Loader,
)
from semantic_pyramid_for_image_generation_torch.data.synthetic import (
    synthetic_batch,
)
from semantic_pyramid_for_image_generation_torch.models import make_models
from semantic_pyramid_for_image_generation_torch.ops.cuda.attention import (
    PooledKVAttentionFunction,
    pooled_kv_attention_plain,
)
from semantic_pyramid_for_image_generation_torch.scripts.jpeg_tree import (
    make_jpeg_tree,
)
from semantic_pyramid_for_image_generation_torch.train.loop import Trainer
from semantic_pyramid_for_image_generation_torch.train.state import (
    TrainState,
    init_train_state,
)
from semantic_pyramid_for_image_generation_torch.train.step import (
    batch_to_device,
    make_generate_fn,
    make_train_step,
)
from semantic_pyramid_for_image_generation_torch.utils.device import (
    card_line,
    exact_float32,
    resolve_device,
)

V100_BASELINE_IMG_PER_SEC = 600_000 / (24 * 3600)  # ~6.94
IMAGES_PER_SEC = "images/sec/chip"
FINETUNE_LR = 1e-4  # the reference's fine-tune learning rate


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="throughput lanes of the port on one card")
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--pallas", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="the hand-written kernels; the port always runs "
                             "them on a CUDA tensor, so --no-pallas is "
                             "refused")
    parser.add_argument("--remat", action="store_true", default=False,
                        help="recompute the VGG-fake forward in the backward")
    parser.add_argument("--remat-blocks", dest="remat_blocks",
                        action="store_true", default=False,
                        help="recompute G/D residual blocks in the backward")
    parser.add_argument("--canonical-projection", dest="canonical",
                        action="store_true", default=False,
                        help="canonical (B,1) projection head instead of the "
                             "reference's (B,B,128) broadcast quirk")
    parser.add_argument("--fused-d", dest="fused_d", action="store_true",
                        default=False,
                        help="perf mode: one D(real++fake) 2B pass "
                             "(implies --canonical-projection)")
    parser.add_argument("--host-pipeline", dest="host_pipeline",
                        action="store_true", default=False,
                        help="the loader's rate over a JPEG tree, then the "
                             "host-fed step's")
    parser.add_argument("--trainer", action="store_true", default=False,
                        help="the real Trainer.train loop, host-fed")
    parser.add_argument("--scan-steps", dest="scan_steps",
                        default=True, action=argparse.BooleanOptionalAction,
                        help="queue --steps train steps with no host sync "
                             "between them: the device rate (the default "
                             "lane)")
    parser.add_argument("--per-step", dest="scan_steps",
                        action="store_false",
                        help="one scalar fetch after every step")
    parser.add_argument("--check-pallas", dest="check_pallas",
                        action="store_true", default=False,
                        help="assertion lane: the attention kernel (forward "
                             "+ grads) against an fp32 oracle at the "
                             "generator's shape; exits nonzero on FAIL")
    parser.add_argument("--vgg-finetune", dest="vgg_finetune",
                        action="store_true", default=False,
                        help="the VGG16 fine-tune step "
                             "(cli/vgg16_finetune.py's CE + Adam update)")
    parser.add_argument("--serving", action="store_true", default=False,
                        help="the eval-mode generation path; --batch_size 1 "
                             "for the latency point")
    parser.add_argument("--serving-artifact", dest="serving_artifact",
                        action="store_true", default=False,
                        help="the exported serving program (serving/"
                             "export.py), read back as a deployment reads "
                             "it; comparable to --serving")
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--channel_factor", type=float, default=1.0,
                        help="shrink G/D widths (CPU runs only; the headline "
                             "number is full width)")
    parser.add_argument("--vgg_width_factor", type=int, default=1,
                        help="shrink VGG widths (CPU runs only)")
    parser.add_argument("--num_workers", type=int, default=16)
    parser.add_argument("--compact-feed", dest="compact_feed",
                        default=True, action=argparse.BooleanOptionalAction,
                        help="host-fed lanes: uint8 images/masks, normalized "
                             "on the device (~4x fewer feed bytes)")
    parser.add_argument("--float-feed", dest="compact_feed",
                        action="store_false",
                        help="alias for --no-compact-feed")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda | cpu (cuda raises without a card)")
    return parser


def emit(metric: str, value: float, unit: str = IMAGES_PER_SEC,
         vs_baseline: float | None = None, digits: int = 2) -> Dict:
    """Print and return the lane's one JSON line; `vs_baseline` defaults to
    the value over the V100 anchor."""
    if vs_baseline is None:
        vs_baseline = round(value / V100_BASELINE_IMG_PER_SEC, 2)
    line = {"metric": metric, "value": round(value, digits), "unit": unit,
            "vs_baseline": vs_baseline}
    print(json.dumps(line), flush=True)
    return line


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_config(args) -> PyramidGANConfig:
    return PyramidGANConfig(
        compute_dtype=args.dtype, remat_blocks=args.remat_blocks,
        channels_factor=args.channel_factor,
        vgg_width_factor=args.vgg_width_factor,
        compat_projection=not (args.canonical or args.fused_d))


def serving_config(args) -> PyramidGANConfig:
    return PyramidGANConfig(compute_dtype=args.dtype,
                            channels_factor=args.channel_factor,
                            vgg_width_factor=args.vgg_width_factor)


def train_setup(args, device: torch.device):
    """(state, step, batch, rng) of the synthetic-batch train lanes: a random
    init from seed 0, the step with the perf-mode flags, one synthetic batch
    on the device, the latent generator seeded 1."""
    config = train_config(args)
    state = init_train_state(config, device)
    step = make_train_step(remat_vgg=args.remat,
                           fused_discriminator=args.fused_d)
    batch = batch_to_device(synthetic_batch(
        config, args.batch_size, np.random.default_rng(0)), device)
    return state, step, batch, torch.Generator(device).manual_seed(1)


def scan_steps_lane(args, device: torch.device) -> Tuple[Dict, TrainState]:
    """The default lane; returns the line and the state after both walks."""
    state, step, batch, rng = train_setup(args, device)

    def walk() -> float:
        for _ in range(args.steps):
            _, metrics = step(state, batch, rng)
        sync(device)
        return float(metrics["loss_generator"])  # the one fetch

    walk()  # warm-up walk: first-use kernel build, allocator, cuDNN plans
    t0 = time.perf_counter()
    final = walk()
    dt = time.perf_counter() - t0
    if not np.isfinite(final):
        raise FloatingPointError(f"loss_generator {final}")
    rate = args.batch_size * args.steps / dt
    return emit(f"{IMAGES_PER_SEC}, 256x256 fused G/D train step, "
                f"{args.steps} steps queued with no host sync between "
                f"them, then one sync and one fetch (device rate)",
                rate), state


def per_step_lane(args, device: torch.device) -> Tuple[Dict, TrainState]:
    """--per-step; returns the line and the state."""
    state, step, batch, rng = train_setup(args, device)
    for _ in range(args.warmup):
        _, metrics = step(state, batch, rng)
    float(metrics["loss_generator"])
    t0 = time.perf_counter()
    for _ in range(args.steps):
        _, metrics = step(state, batch, rng)
        float(metrics["loss_generator"])  # one fetch per step
    dt = time.perf_counter() - t0
    rate = args.batch_size * args.steps / dt
    return emit(f"{IMAGES_PER_SEC}, 256x256 fused G/D train step (one "
                f"scalar fetch per step)", rate), state


def trainer_per_class(batch_size: int, steps: int) -> int:
    """JPEGs per class (4 classes) of the --trainer tree: enough that one
    timed epoch holds at least `steps` batches."""
    return max(16, -(-batch_size * steps // 4))


def trainer_lane(args, device: torch.device, per_class: int | None = None
                 ) -> Dict:
    """--trainer; `per_class` overrides `trainer_per_class` (tests)."""
    config = train_config(args)
    per_class = per_class or trainer_per_class(args.batch_size, args.steps)
    with tempfile.TemporaryDirectory() as root, \
            tempfile.TemporaryDirectory() as save_dir:
        make_jpeg_tree(root, config.image_size, per_class=per_class)
        loader = Places365Loader(
            Places365(root, "train.txt", config),
            batch_size=args.batch_size, num_workers=args.num_workers,
            prefetch=2, compact_feed=args.compact_feed)
        trainer = Trainer(config, loader, validation_dataset=None,
                          save_data_path=save_dir, device=device,
                          remat_vgg=args.remat,
                          fused_discriminator=args.fused_d,
                          allow_random_fid=True)
        # epoch 1: first use of the kernels, the page cache, checkpoint_000
        t0 = time.perf_counter()
        trainer.train(epochs=1, validate_at_start=False, progress=False,
                      log_every=args.log_every)
        sync(device)
        warmup_wall = time.perf_counter() - t0
        n_before = trainer.samples_seen
        t0 = time.perf_counter()
        # cadence > epoch counter: the timed epoch runs the loop only
        trainer.train(epochs=1, validate_at_start=False, progress=False,
                      log_every=args.log_every,
                      save_model_after_n_epochs=10**9)
        sync(device)  # the epoch-end metric fetch already waited
        dt = time.perf_counter() - t0
        n_images = trainer.samples_seen - n_before
    rate = n_images / dt
    return emit(f"{IMAGES_PER_SEC}, 256x256 production Trainer.train "
                f"(host-fed, log_every={args.log_every}; per-epoch "
                f"checkpoint excluded from the timed epoch, warm-up epoch "
                f"incl. first use and the checkpoint save took "
                f"{round(warmup_wall - dt, 1)}s longer)", rate)


def host_pipeline_lane(args, device: torch.device) -> Dict:
    """--host-pipeline."""
    config = train_config(args)
    with tempfile.TemporaryDirectory() as root:
        make_jpeg_tree(root, config.image_size,
                       per_class=max(16, args.batch_size // 2))
        loader = Places365Loader(
            Places365(root, "train.txt", config),
            batch_size=args.batch_size, num_workers=args.num_workers,
            prefetch=2, compact_feed=args.compact_feed)
        for _ in loader:  # warm the page cache and the thread pool
            break
        t0 = time.perf_counter()
        n_images = 0
        for batch in loader:
            n_images += batch["images"].shape[0]
        loader_rate = n_images / (time.perf_counter() - t0)

        state = init_train_state(config, device)
        step = make_train_step(remat_vgg=args.remat,
                               fused_discriminator=args.fused_d)
        rng = torch.Generator(device).manual_seed(1)
        first = next(iter(loader))
        for _ in range(args.warmup):
            _, metrics = step(state, batch_to_device(first, device), rng)
        float(metrics["loss_generator"])
        t0 = time.perf_counter()
        n_images = steps_done = 0
        while steps_done < args.steps:
            for batch in loader:
                _, metrics = step(state, batch_to_device(batch, device), rng)
                n_images += batch["images"].shape[0]
                steps_done += 1
                if steps_done >= args.steps:
                    break
        float(metrics["loss_generator"])
        dt = time.perf_counter() - t0
    feed = "uint8" if args.compact_feed else "float32"
    route = "native" if loader.use_native_masks else "numpy"
    return emit(f"{IMAGES_PER_SEC}, 256x256 host-fed ({feed} feed, JPEG "
                f"decode + {route} masks) train step; loader alone: "
                f"{round(loader_rate, 1)}", n_images / dt)


def serving_setup(args, device: torch.device):
    """(config, eval-mode generator and VGG from seed 0, a validation batch
    on the device)."""
    config = serving_config(args)
    generator, vgg = make_models(config, device,
                                 torch.Generator(device).manual_seed(0))
    batch = batch_to_device(synthetic_batch(
        config, args.batch_size, np.random.default_rng(0), validation=True),
        device)
    return config, generator, vgg, batch


def timed_generates(args, device: torch.device, config: PyramidGANConfig,
                    call: Callable[[torch.Tensor], torch.Tensor]) -> float:
    """Seconds of `--steps` calls of `call(noise)`, each with its own noise
    drawn on the device, then one sync, after an untimed walk of as many."""
    rng = torch.Generator(device).manual_seed(1)

    def walk() -> float:
        for _ in range(args.steps):
            fake = call(torch.randn((args.batch_size, config.latent_dim),
                                    generator=rng, device=device))
        sync(device)
        return float(fake[0, 0, 0, 0])  # one pixel of the last call

    walk()
    t0 = time.perf_counter()
    probe = walk()
    dt = time.perf_counter() - t0
    if not np.isfinite(probe):
        raise FloatingPointError(f"generated {probe}")
    return dt


def serving_lane(args, device: torch.device) -> Dict:
    """--serving."""
    config, generator, vgg, batch = serving_setup(args, device)
    generate = make_generate_fn(generator, vgg)
    dt = timed_generates(args, device, config, lambda noise: generate(
        batch["images"], batch["masks"], batch["labels"], noise))
    return emit(f"{IMAGES_PER_SEC}, 256x256 serving generate (VGG pyramid "
                f"+ G eval fwd, batch {args.batch_size}; "
                f"{round(1000.0 * dt / args.steps, 1)} ms/call, "
                f"{args.steps} calls queued, one sync)",
                args.batch_size * args.steps / dt)


def serving_artifact_lane(args, device: torch.device) -> Dict:
    """--serving-artifact."""
    from semantic_pyramid_for_image_generation_torch.serving.export import (
        save_artifact,
    )
    from semantic_pyramid_for_image_generation_torch.serving.program import (
        ProgramArtifact,
        load_artifact,
        program_file,
    )

    config, generator, vgg, batch = serving_setup(args, device)
    masks = tuple(m.float() for m in batch["masks"])
    with tempfile.TemporaryDirectory() as out:
        save_artifact(generator, vgg, out, [args.batch_size],
                      platforms=[device.type], weights="external",
                      classifier=False)
        program_kb = os.path.getsize(os.path.join(out, program_file(
            "generate", args.batch_size, device.type))) / 1e3
        artifact = load_artifact(out, device)
    if not isinstance(artifact, ProgramArtifact):
        raise TypeError(f"load_artifact gave {type(artifact).__name__}")
    del generator, vgg
    dt = timed_generates(args, device, config, lambda noise: artifact.generate(
        batch["images"], masks, batch["labels"], noise))
    return emit(f"{IMAGES_PER_SEC}, 256x256 serving generate via the "
                f"EXPORTED torch.export program ({program_kb:.0f} KB "
                f"program, external weights, batch {args.batch_size}; "
                f"{round(1000.0 * dt / args.steps, 1)} ms/call, "
                f"{args.steps} calls queued, one sync)",
                args.batch_size * args.steps / dt)


def vgg_finetune_lane(args, device: torch.device) -> Dict:
    """--vgg-finetune."""
    from semantic_pyramid_for_image_generation_torch.cli import (
        vgg16_finetune as finetune,
    )

    config = PyramidGANConfig(compute_dtype=args.dtype,
                              vgg_width_factor=args.vgg_width_factor)
    model = finetune.build_model(config, device, None)
    step = finetune.make_finetune_step(
        model, finetune.make_optimizer(model, FINETUNE_LR))
    host = np.random.default_rng(0)
    images, labels = finetune.batch_to_device(
        host.random((args.batch_size, config.image_size, config.image_size,
                     3), np.float32),
        host.integers(0, config.num_classes, args.batch_size), device)
    rng = torch.Generator(device).manual_seed(1)
    for _ in range(args.warmup):
        loss, _ = step(images, labels, rng)
    float(loss)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss, _ = step(images, labels, rng)
        float(loss)  # one fetch per step
    dt = time.perf_counter() - t0
    return emit(f"{IMAGES_PER_SEC}, 256x256 VGG16 fine-tune step (fwd + CE "
                f"+ Adam, cli/vgg16_finetune.py)",
                args.batch_size * args.steps / dt)


def _forward_and_grads(fn, q, k, v, ct) -> list:
    """fn(q, k, v) and its gradients in q, k, v for the output gradient ct,
    as float64 numpy arrays."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), ct.to(out.dtype))
    return [t.detach().double().cpu().numpy() for t in (out, *grads)]


def check_pallas_lane(args, device: torch.device) -> Dict:
    """--check-pallas; raises SystemExit(1) on FAIL, after its line."""
    b, nq, nk, c8, c2 = args.batch_size // 64 or 2, 1024, 256, 32, 128
    host = np.random.default_rng(0)
    report, ok = {}, True
    with exact_float32():  # the fp32 products without TF32, oracle included
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.as_tensor(host.standard_normal(shape),
                                       dtype=dtype, device=device)
                       for shape in ((b, nq, c8), (b, nk, c8), (b, nk, c2)))
            # fp32 copies of the same (dtype-rounded) values, upcast on the
            # host
            q32, k32, v32 = (torch.as_tensor(t.cpu().float().numpy(),
                                             device=device) for t in (q, k, v))
            ct = torch.as_tensor(host.standard_normal((b, nq, c2)),
                                 dtype=torch.float32, device=device)
            ref = _forward_and_grads(pooled_kv_attention_plain, q32, k32, v32,
                                     ct)
            kernel = _forward_and_grads(PooledKVAttentionFunction.apply, q, k,
                                        v, ct)
            plain = _forward_and_grads(pooled_kv_attention_plain, q, k, v, ct)
            e_kernel = max(np.abs(t - r).max() for t, r in zip(kernel, ref))
            e_plain = max(np.abs(t - r).max() for t, r in zip(plain, ref))
            if dtype == torch.float32:
                passed = bool(e_kernel <= 1e-3)
            else:
                passed = bool(e_kernel <= 2.0 * e_plain + 1e-2)
            report[str(dtype).removeprefix("torch.")] = {
                "kernel_vs_oracle": round(float(e_kernel), 6),
                "plain_vs_oracle": round(float(e_plain), 6), "pass": passed}
            ok = ok and passed
    line = emit(f"attention kernel fwd+grads vs fp32 oracle (TF32 off) at "
                f"generator shape (q {nq}x{c8}, kv {nk}x{c2}, batch {b}) on "
                f"{device.type}: {'PASS' if ok else 'FAIL'} {report}",
                report["float32"]["kernel_vs_oracle"],
                unit="max abs diff (kernel vs oracle, fp32 fwd+grads)",
                vs_baseline=1.0 if ok else 0.0, digits=6)
    if not ok:
        raise SystemExit(1)
    return line


def lane_of(args) -> Callable:
    """The lane the flags select, in the root script's order."""
    for flag, lane in (("host_pipeline", host_pipeline_lane),
                       ("trainer", trainer_lane),
                       ("check_pallas", check_pallas_lane),
                       ("vgg_finetune", vgg_finetune_lane),
                       ("serving", serving_lane),
                       ("serving_artifact", serving_artifact_lane),
                       ("scan_steps", scan_steps_lane)):
        if getattr(args, flag):
            return lane
    return per_step_lane


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.pallas:
        parser.error("--no-pallas: the port has no route without its "
                     "kernels; on a CUDA tensor it always launches them "
                     "(--device cpu runs their plain versions)")
    device = resolve_device(args.device)  # cuda without a card raises here
    print(f"card: {card_line() if device.type == 'cuda' else 'cpu'}",
          flush=True)
    lane_of(args)(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
