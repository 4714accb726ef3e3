#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): the serving path,
the fused G/D train step, the Trainer, the VGG-16 fine-tune, data-parallel
training, the train step's perf modes, sharded training state, the
serving programs, the evaluation and training entry points, the root
entry points (the throughput lanes, graft_entry's entry() and dry run) and
the profiling entry points (the train step's per-op roofline, three
microbenchmarks).

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
    streams bytes can expect on this card. Last, checked against their
    plain versions and not timed: the three forwards at the Trainer's
    generate batches (32: validation, 49: the grid, 64: phase 14's FID and
    rehearsal), Kernel 2 at phase 14's VGG eval batch, and all five kernels
    at the sites of every train step the smoke drives, per rank (16 rows in
    bf16 and fp32, 64 and 32 in bf16, 8 in fp32), the loss's fp32 pools
    of the features and masks included, and Kernels 1, 2 and 4 at phase
    11's fused D pass over real ++ fake (2 x 64 rows in bf16, 2 x 8 in
    fp32). Then the batch norms' Kernels 6-9 (bf16 only) at BN_SITES,
    BigGAN-deep's two largest at its cell's 64 rows and the SP-GAN's two
    largest at batch 16, once more with x off 16-byte alignment (their
    element-wise form): each against its plain version in the card tests'
    bands, then kernel, bound, plain and `torch.batch_norm` ms.
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
    pool 30, max-pool backward 14, upsample backward 11, and in bf16 the
    batch norms' statistics 22, apply 22, backward sums 11, backward dx 11
    (G's 11 training batch norms in its two forwards and one backward;
    none in fp32 or in any eval generate).
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
    the bytes written. (d) The modules reader (serving/export.py::
    ServingArtifact, which reads JAX artifacts): phase 5's bf16 modules
    written with buckets (1, 16), the programs taken out of the manifest
    (a JAX artifact lists none), read back by load_artifact, two requests
    equal to the in-memory service's. The phase's seconds.
 9. torch.profiler over single warm requests per bucket and dtype, over
    one warm train step at batch 16 per dtype, and over one warm bf16
    fine-tune step at batch 256: device time by kernel and by kind of op,
    the kernels' share, the device's busy share.
10. Data parallelism (parallel/mesh.py). The card machine has one card, so
    this is two gloo ranks sharing it and one rank over NCCL: the
    arithmetic, not a multi-card speed. (a) Two ranks spawned (the spawn
    start method) on cuda:0, full width, bf16, 32 rows each of global
    batches of 64, 3 steps: per rank, launch deltas exactly as phase 6's per
    step, ms per step, the bytes all-reduced and all-gathered per step;
    after the steps G, D, both Adam states, u/v and running statistics
    bitwise equal on both ranks (sha256). (b) The same two ranks in fp32,
    8 rows each of global batches of 16 with pinned latents, 2 steps,
    against this process stepping the 16 rows from the same state, for
    each of seeds 0, 1 and 2 (the initial state and the batches): every
    metric within 1e-4 relative, at most 0.1% of G's and of D's elements
    further than 1% of an Adam step, the first step's gradients within
    1e-3 relative L2 per network and 1e-5 for the projection's embedding,
    each limit raised to 6x what the seed's witness reads (this process
    stepping the same rows with each half reversed: the same arithmetic in
    another summation order); ranks bitwise equal; G's elements off over
    the witness's, per seed and run. (c) Four planted faults, each a
    global reduction made local (batch-norm moments, diversity halves,
    projection rows, gradients averaged instead of summed), each must break
    (b)'s hold on every seed. The planted faults, the readings and the row
    helpers are tests/torch_parallel_rank.py's, which the CPU tests use.
    (d) One rank over NCCL in this process: bf16 batch-64 steps timed
    without a group and in it; the Trainer at batch 64 (4 steps, the
    epoch-end grid and checkpoint; launches counted) and one validation
    from G and the eval generator as phase 7's last validation had them,
    on its batches: moments and FID equal to phase 7's. Ranks are joined
    within 300 s and killed past it; the group has a 120 s timeout.
11. The train step's perf modes (`--fused_d`, `--remat_vgg`,
    `--remat_blocks`). (a) Full-width bf16 steps at batch 64 from one
    state, 1 warm-up and 5 timed per mode: the default step, the canonical
    projection alone (what --fused_d implies), each mode alone and all
    three; median ms and spread, peak GiB; launch counters are reset before
    (a) and each step must move them by its mode's counts
    (tests/torch_parallel_rank.py's PERF_MODE_LAUNCHES). (c) and (d) on
    seeds 0, 1 and 2, fp32, full width, batch 8, every reading printed
    before any check (`readings_against`: metrics, each network's elements
    off and first gradients, u/v, running statistics), each limit the
    larger of a floor and 6x the seed's witness, and the sound runs'
    largest and the faults' smallest reading per limit. (c) 2 steps:
    remat_vgg, remat_blocks and both against the default step, witness the
    default step again; three planted faults of remat_blocks' recompute
    (unguarded; u/v only; the running statistics' momentum only) must each
    break the hold. (d) fused_d against the separate passes, 3 steps with
    spectral updates frozen (u/v untouched: limit 0), witness the separate
    passes on each half of the batch reversed; each run also reads the
    first step's real loss with updates on. Two planted faults of the fused
    pass (the fakes' labels shifted a row; D's u/v advanced once more) must
    each break it. (e) The CLI at full width on a JPEG Places365 tree:
    `--train --fused_d --remat_vgg --remat_blocks`, bf16, 2 steps of 16, a
    validation of 32 (sites that phase 3 holds), checkpoint_000.pt; a
    default-mode run resumes from it and takes 2 more. (f) Two gloo ranks
    on cuda:0 with `--fused_d --remat_blocks`, fp32, as phase 10 (b) on seed 0: the ranks
    bitwise, the hold against this process under phase 10's limits and
    witness, launches, and the bytes all-reduced and all-gathered per rank
    per step exactly as tests/torch_parallel_rank.py's
    `step_collective_bytes` works them out.
12. Sharded state (`--fsdp 2`, parallel/mesh.py::shard_state): two gloo
    ranks on cuda:0 as one (1, 2) (data, fsdp) mesh. (a) Phase 10's
    full-width bf16 state sharded, 6 steps of 32 rows each of global
    batches of 64: each rank's bytes of parameters and Adam moments read
    and worked out (`sharded_state_bytes`; unsharded, 1.10 GB), memory
    allocated before and after sharding and the peak, ms per step (median
    of 5, spread) beside phase 10's `--fsdp 1` ranks, FSDP's all-gather
    and reduce-scatter bytes per step counted and worked out
    (`step_collective_bytes`), launches per step exactly phase 6's, the
    ranks bitwise equal. (b) Phase 10 (b)'s fp32 hold on seeds 0-2 with
    its witness and limits, and on seed 0 the four planted faults of
    sharded state (tests/torch_parallel_rank.py's FSDP_FAULTS), each of
    which must break it. (c) The CLI at full width in bf16, global batch 16:
    `--multihost --fsdp 2 --train` on two gloo ranks (the rank's
    `init_distributed` asks for gloo: NCCL puts one rank on a card)
    trains, validates and writes checkpoint_000.pt; one process restores
    it and trains on; the two ranks restore that file and validate.
13. Serving programs (serving/export.py, serving/program.py). (a) Phase
    5's full-width modules, bf16 and fp32, exported as `cuda` programs:
    external weights at buckets 1 and 16 with the classifier (and the
    prepare program, which lays weights.npz out once at load), baked at
    bucket 1 (laid out at export); export seconds and the bytes of every
    file. (b) A fresh process (spawned) loads each
    artifact with ProgramArtifact and serves one request of each kind
    (external: bucket 1 with the auto class and with class 42, bucket 16;
    baked: bucket 1 with class 42);
    its load seconds and first-request ms; it must import no module of
    models/, train/ or serving/export.py. (c) This process loads them
    again; with the counters reset, one request of each kind through the
    programs gives `program_launches`; each request's launches must equal
    the eager request's (ServingArtifact.from_modules), the fresh
    process's and phase 5's rule (1 attention, 11 upsample, 6 max pool, 5
    more for the auto class); outputs held against eager and the fresh
    process's against this one's (fp32 within 5e-6, bf16 within 0.05 max /
    0.005 mean; bitwise or not, said); 8 requests each of eager and
    program timed in turns (median, min-max ms); a profile of one warm bf16
    program request per bucket. The phase's seconds.
14. The evaluation entry points (scripts/). (a) The artifact selftest's
    main() at full width on stand-ins written to a temporary directory
    (random VGG-16 .pt files from SEED, the caffe one with the tree's two
    classes biased up so that its top-5 must read 100%; the random-init
    Inception's state dict; a Places365 tree of EV_VAL validation JPEGs),
    with the relaxed expectations of tests/test_artifact_selftest.py: the
    JSON report (`passed` must be true and all six results there), each
    evaluation's seconds and launches (per VGG eval batch 5 max pools; per
    generate 1 / 6 / 11; none in the self-FID). (b) The FID rehearsal's
    parts: RH_IMAGES images at batch RH_BATCH in bf16, the moments pass
    (images/s, launches per generate) and the device statistics (seconds,
    FID), peak GiB. Both run in a fresh process (spawned), as a user runs
    the scripts, joined within EV_TIMEOUT_S. The phase's seconds.
15. The training entry points (scripts/). (a) The long run's run() at full
    width in bf16 on a JPEG tree it builds in a temporary directory
    (LR_PER_CLASS x 2 classes, 16 x 2 validation JPEGs): cli/main.py with
    the compact feed and 16 loader threads, 2 epochs of 2 steps of 64, the
    start-of-run validation, 3 grids and 2 checkpoints; its output, the
    summary (finite, its steps and files) and launches exactly 4 steps' and
    4 generates' (worked out from Trainer.train). (b) One batch of that
    tree through Places365Loader in the compact and the float feed: the
    uint8 batch reaches the card as uint8, ensure_m11_images normalizes it
    there in float32, within CF_TOLERANCE of the float batch; masks and
    labels equal. (c) The loader scaling bench's run() at workers 1 and 8
    on 128 JPEGs: its rows and summary (`mask_route`, the card's bf16
    batch-64 step rate), launches exactly 7 train steps'. All in a fresh
    process (spawned), joined within TR_TIMEOUT_S. The phase's seconds.
16. The root entry points (graft_entry.py, bench.py), in a fresh process
    (spawned) joined within RE_TIMEOUT_S. (a) entry(): the full-width fp32
    Generator's eval forward at batch 4 on its example arguments: shape,
    finite, launches exactly one Generator forward's (1 attention, its KV
    max pool, 11 upsamples); then, with u/v advanced 10 power iterations
    (from an init's random u/v every pixel saturates the tanh), on those
    and on random arguments, the same call with the three forward kernels
    swapped for their plain versions (no launch), within
    RE_ENTRY_TOLERANCE, under 1% of pixels saturated; fn traced by
    torch.export, its program against fn. (b) dryrun_multichip(4): four gloo ranks sharing the card as
    a (2, 2) (data, fsdp) mesh; its OK line, the grid side 1808, rank 0's
    launches exactly one train step's and 4 generates'. (c) Each of the
    bench's eight lanes at full width in bf16, RE_ARGV (batch 16, 2 steps,
    1 warm-up): its output prefixed `  | `, its one JSON line (value finite
    and positive), launches exactly what the lane runs (`lane_launches`:
    train steps 5 / 22 / 30 / 14 / 11, generates 1 / 11 / 6, fine-tune
    steps' 5 pools and 5 pool backwards, 2 attention forwards for the
    check); --check-pallas must read PASS in fp32 and bf16. The phase's
    seconds.
17. The profiling entry points (scripts/profile_step.py and the three
    microbenchmarks), in a fresh process (spawned) joined within
    PF_TIMEOUT_S. (a) profile_step's capture and
    analyze at full width, bf16, PS_ARGV (batch 128, 2 profiled steps, 1
    warm-up): the device us per step, wall and unprofiled us per step,
    busy share, category shares, FLOPs and MFUs, the top ops and data-
    formatting kernels; held: launches per step from the trace exactly
    the train step's (5 / 30 / 22 / 14 / 11), the counters exactly that
    times every step the capture ran, the category shares summing to 100
    within PS_SHARE_SLACK, 0 < step_mfu_pct <= 100 (profiled and not).
    (b) finalblock_bench, inputconv_bwd_bench and s2d_stem_bench with
    MB_ARGV (batch 128, 3 iterations, bf16): their output prefixed `  | `;
    held: each float32 check within the script's tolerance (the tolerance
    its test states), every time finite and positive, and the finalblock
    chains' launches per iteration one Kernel 3 and one Kernel 5. (c)
    Kernels 3 and 5 at the final block's shape, (B, 64, 128, 128) ->
    (B, 64, 256, 256), against their plain versions in bf16 and fp32: timed
    at batch 128 as phase 8 (b) times its batch-256 sites (kernel, plain,
    library and bound ms), held at the finalblock bench's check batch. The
    phase's seconds and the smoke's.
18. The `kernels` JSON line (launches from the train path; the serving,
    Trainer, fine-tune, rank-0 (a), perf-mode, sharded rank-0, program,
    evaluation and training-script paths' as `serving_launches`,
    `trainer_launches`, `finetune_launches`, `parallel_rank_launches`,
    `perf_mode_launches` (with `perf_mode_launches_per_step` per mode),
    `fsdp_rank_launches`, `program_launches`, `selftest_launches`,
    `rehearsal_launches`, `long_run_launches`, `loader_bench_launches`,
    `entry_launches`, `dryrun_rank_launches`, `bench_launches` (with
    `bench_launches_per_lane`), phase 17's as `profile_step_launches`
    (with `profile_step_launches_per_step` from the trace) and, for
    Kernels 3 and 5, `finalblock_launches_per_iter` and `finalblock`
    (the final block's shape per dtype); Kernels 2 and 4 at the fine-tune's
    sites as `finetune_batch256`), the
    card line again, and last the device line.

Imports torch, numpy and the port only; needs one card and no network.
"""

from __future__ import annotations

import contextlib
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
BATCH_NORM_KERNELS = ("batch_norm_stats", "batch_norm_apply",
                      "batch_norm_backward_sums", "batch_norm_backward_dx")
NO_BATCH_NORMS = dict.fromkeys(BATCH_NORM_KERNELS, 0)
TRAIN_LAUNCHES = {  # per bf16 train step (chip_smoke phase 6); G's 11
    # training-mode batch norms run Kernels 6 and 7 in its two forwards (D
    # phase, G phase) and Kernels 8 and 9 in its one backward
    "pooled_kv_attention": 5, "upsample_2x": 22, "max_pool_2x2": 30,
    "max_pool_2x2_backward": 14, "upsample_2x_backward": 11,
    "batch_norm_stats": 22, "batch_norm_apply": 22,
    "batch_norm_backward_sums": 11, "batch_norm_backward_dx": 11}
# per float32 train step: its batch norms keep the literal order
FP32_TRAIN_LAUNCHES = dict(TRAIN_LAUNCHES, **NO_BATCH_NORMS)
GENERATE_LAUNCHES = {  # per eval generate (VGG pyramid, then G)
    "pooled_kv_attention": 1, "upsample_2x": 11, "max_pool_2x2": 6,
    "max_pool_2x2_backward": 0, "upsample_2x_backward": 0, **NO_BATCH_NORMS}
# the train step's perf modes (phase 11), their config fields, make_train_step
# flags and launches per step: tests/torch_parallel_rank.py's PERF_MODES and
# PERF_MODE_LAUNCHES (`parallel_helpers()`), which the CPU tests use
TRAINER_STEPS = 4  # phase 7: training batches of BATCH
VALIDATION_BATCHES = 2  # phase 7: validation batches of 2 * BATCH


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


def loss_pools(batch=BATCH):
    """The reconstruction loss's pool inputs: the 5 pyramid features."""
    return [(b, c, h // 2, w // 2) for b, c, h, w in vgg_pools(batch)]


def train_pool_sites(dtype, batch=BATCH):
    """Kernel 2 in one train step, each shape once: the VGG pools (compute
    dtype), the KV pool, and the loss pools of the features and of their
    masks (fp32)."""
    masks = [(b, 1, h, w) for b, _, h, w in loss_pools(batch)]
    return (pool_sites(dtype, batch)
            + [(shape, torch.float32) for shape in loss_pools(batch) + masks])


def pool_backward_sites(dtype, batch=BATCH):
    """Kernel 4 in one train step: the 5 VGG pools on the fakes (compute
    dtype), the 5 loss pools on the fake features (fp32), the KV pool of D
    on real and fake (D phase) and on fake (G phase), and of G (G phase)."""
    return ([(shape, dtype) for shape in vgg_pools(batch)]
            + [(shape, torch.float32) for shape in loss_pools(batch)]
            + [(kv_pool(batch), dtype)] * 4)


def upsample_backward_sites(dtype, batch=BATCH):
    """Kernel 5 in one train step: the gradients of the 11 upsample outputs
    of the G phase's forward, (B, C, 2H, 2W)."""
    return [((b, c, 2 * h, 2 * w), dtype)
            for b, c, h, w in upsample_shapes(dtype, batch)]


def generate_batches():
    """Rows of every generate the smoke's Trainers run: phase 7's validation
    at 2 x 16 and 11 (e)'s CLI validation at 2 x its batch, 12 (c)'s per
    rank at 2 x its batch over the two ranks, the 7x7 grid; phase 14's
    selftest FID (one validation batch) and rehearsal batch; phase 15's
    long-run validation (its 32 FID images in one batch) and the
    full-default long run's validation batch of 2 x 64."""
    return sorted({2 * BATCH, 2 * PM_CLI_BATCH, 2 * FS_CLI_BATCH // DP_WORLD,
                   49, min(EV_FID_IMAGES, 2 * EV_BATCH), RH_BATCH,
                   LR_VALIDATION_ROWS, LR_FULL_VALIDATION_ROWS})


def train_site_batches():
    """(rows, dtype) of every train step the smoke drives: phases 6 and 7 at
    16 rows (bf16 and fp32), phase 6's peak-memory step and 10 (d) at 64 in
    bf16, a rank of 10 (a) at 32 in bf16 and of 10 (b) at 8 in fp32, the
    one-process reference of 10 (b) at 16 in fp32; phase 11 (a) at 64 in
    bf16, (c) and (d) at 8 in fp32, (e)'s CLI in bf16 at its batch; a rank
    of phase 12 (a) at 32 in bf16 and of (b) at 8 in fp32, of (c)'s CLI at
    its batch over the two ranks in bf16; phase 15's long run and loader
    bench at 64 in bf16; phase 17's profile_step at 128 in bf16."""
    return list(dict.fromkeys([
        (BATCH, torch.bfloat16), (BATCH, torch.float32),
        (NCCL_BATCH, torch.bfloat16),
        (DP_BF16_BATCH // DP_WORLD, torch.bfloat16),
        (DP_FP32_BATCH // DP_WORLD, torch.float32),
        (DP_FP32_BATCH, torch.float32),
        (PM_BATCH, torch.bfloat16), (PM_FP32_BATCH, torch.float32),
        (PM_CLI_BATCH, torch.bfloat16),
        (FS_CLI_BATCH // DP_WORLD, torch.bfloat16),
        (LR_BATCH, torch.bfloat16), (PS_BATCH, torch.bfloat16)]))


def fused_d_site_batches():
    """(rows, dtype) of every fused D pass of phase 11 (2B rows): (a) at 2 x
    64 in bf16, (d) at 2 x 8 in fp32, (e)'s CLI at 2 x its batch in bf16,
    (f)'s ranks at 2 x 8 and its one-process reference at 2 x 16 in fp32."""
    return list(dict.fromkeys([
        (2 * PM_BATCH, torch.bfloat16), (2 * PM_FP32_BATCH, torch.float32),
        (2 * PM_CLI_BATCH, torch.bfloat16),
        (2 * (DP_FP32_BATCH // DP_WORLD), torch.float32),
        (2 * DP_FP32_BATCH, torch.float32)]))


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


def kernel_specs(device) -> dict:
    """Per kernel: its source, the TPU kernel it replaces, its main path's
    sites, input maker, wrapper, plain version, library yardstick, FLOPs,
    output bytes and tolerance against the plain version."""
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
            sites=attention_sites, train_sites=attention_sites,
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
            sites=pool_sites, train_sites=train_pool_sites,
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
            sites=upsample_sites, train_sites=upsample_sites,
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
            sites=pool_backward_sites, train_sites=pool_backward_sites,
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
            sites=upsample_backward_sites, train_sites=upsample_backward_sites,
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

    return specs


def measure_site(name: str, spec: dict, shape, site_dtype,
                 large: bool = False) -> dict:
    """One site: the kernel against its plain version (raises beyond the
    tolerance), then the kernel's, the plain version's and the library
    yardstick's ms and the bound's (bytes and FLOPs) in ms. A `large` site
    is timed as phase 8 (b) times its batch-256 sites: the kernel and the
    library over 7 windows of 5 calls, the plain version over 3 calls."""
    reps = {"kernel": (7, 5), "plain": (3, 1)} if large else {
        "kernel": (21, 10), "plain": (21, 10)}
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
    ms = time_ms(lambda: spec["kernel"](*args), *reps["kernel"])
    t_bytes = (nbytes(*args) + spec["out_bytes"](*args)) \
        / HBM_BYTES_PER_S * 1e3
    t_flops = spec["flops"](*args) / PEAK_FLOPS[site_dtype] * 1e3
    bound = max(t_bytes, t_flops)
    print(f"{site} ok, {ms * 1e3:.1f} us, {100 * bound / ms:.0f}% "
          f"of its bound", flush=True)
    return {"max_abs_err": err, "ms": ms,
            "plain_ms": time_ms(lambda: spec["plain"](*args),
                                *reps["plain"]),
            "library_ms": time_ms(spec["library"](*args), *reps["kernel"]),
            "bound_ms": bound, "bytes_ms": t_bytes, "flops_ms": t_flops}


def hold_sites(specs: dict, name: str, sites, what: str) -> None:
    """Each site once against the plain version, not timed."""
    spec, worst = specs[name], 0.0
    sites = list(dict.fromkeys(sites))
    for shape, site_dtype in sites:
        args = spec["make"](shape, site_dtype)
        got = spec["kernel"](*args)
        want = spec["plain"](*args)
        err = (got.float() - want.float()).abs().max().item()
        tol = spec["tol"](site_dtype, want.float())
        if not (torch.equal(got, want) if tol == 0.0 else err <= tol):
            raise AssertionError(f"{name} disagrees with its plain "
                                 f"version at {shape} in {site_dtype}")
        worst = max(worst, err)
        del args, got, want
    print(f"  {name} {what}, {len(sites)} sites: max_abs_err "
          f"{worst:.3g} ok", flush=True)


# Kernels 6-9 at (shape, per-row tables, slope, x's offset in elements):
# BigGAN-deep's largest batch norm (the output BN, per-channel tables, ReLU)
# and its largest conditional one, at its cell's 64 rows; the SP-GAN's
# largest conditional norm and its final BN (LeakyReLU 0.2) at the smoke's
# batch, then that conditional norm with x one element into its storage,
# which takes the kernels' element-wise (VEC = 1) form
BN_SITES = (((64, 128, 256, 256), False, 0.0, 0),
            ((64, 64, 256, 256), True, 0.0, 0),
            ((BATCH, 64, 256, 256), True, 0.2, 0),
            ((BATCH, 64, 256, 256), False, 0.2, 0),
            ((BATCH, 64, 256, 256), True, 0.2, 1))


def time_batch_norm_kernels(device) -> dict:
    """Kernels 6-9 at BN_SITES: each against its plain version (the card
    tests' bands: one bf16 rounding for Kernels 7 and 9, 1e-5 of the sum of
    the terms' magnitudes for the sums of 6 and 8), then its ms, its bound
    (bytes at HBM_BYTES_PER_S), its plain version's ms and a library
    yardstick's, `torch.batch_norm` in training mode forward (Kernels 6, 7)
    and its backward (8, 9), timed here only: the port never calls it. The
    plain versions run over 3 calls, the rest over 7 windows of 5. Returns
    an entry per kernel, as `check_kernels` does, with a row per site."""
    from semantic_pyramid_for_image_generation_torch.ops.cuda import (
        batch_norm as bn,
    )

    g = torch.Generator(device).manual_seed(SEED)
    entries = {name: {"name": name, "route": "cuda",
                      "source": "csrc/batch_norm.cu",
                      "replaces": "none: XLA fuses the JAX package's batch "
                                  "norms", "dtype": "bfloat16", "sites": []}
               for name in BATCH_NORM_KERNELS}
    for shape, per_row, slope, offset in BN_SITES:
        b, c, h, w = shape
        segments = b if per_row else 1
        storage = torch.empty(b * c * h * w + offset, device=device,
                              dtype=torch.bfloat16)
        x = storage[offset:].view(b, h, w, c).permute(0, 3, 1, 2)
        x.copy_(0.5 + 2 * torch.randn(shape, generator=g, device=device))
        dy = torch.randn(shape, generator=g, device=device).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        scale = 1 + 0.3 * torch.randn(segments, c, generator=g, device=device)
        shift = 0.5 * torch.randn(segments, c, generator=g, device=device)
        k = 0.1 * torch.randn(2, c, generator=g, device=device)
        weight, bias = scale[0].clone(), shift[0].clone()
        running = [torch.zeros(c, device=device), torch.ones(c, device=device)]
        _, mean, invstd = torch.native_batch_norm(x, weight, bias, *running,
                                                  True, 0.1, 1e-5)

        def library_forward():
            torch.batch_norm(x, weight, bias, *running, True, 0.1, 1e-5, True)

        def library_backward():
            torch.ops.aten.native_batch_norm_backward(
                dy, x, weight, *running, mean, invstd, True, 1e-5,
                [True, True, True])

        table = 2 * segments * c * 4  # scale and shift, float32
        kernels = {
            "batch_norm_stats": (lambda: bn.batch_norm_stats(x),
                                 lambda: bn.batch_norm_stats_plain(x),
                                 library_forward, nbytes(x) + 2 * c * 4),
            "batch_norm_apply": (
                lambda: bn.batch_norm_apply(x, scale, shift, slope),
                lambda: bn.batch_norm_apply_plain(x, scale, shift, slope),
                library_forward, 2 * nbytes(x) + table),
            "batch_norm_backward_sums": (
                lambda: bn.batch_norm_backward_sums(dy, x, scale, shift,
                                                    slope),
                lambda: bn.batch_norm_backward_sums_plain(dy, x, scale, shift,
                                                          slope),
                library_backward, nbytes(x, dy) + 2 * table),
            "batch_norm_backward_dx": (
                lambda: bn.batch_norm_backward_dx(dy, x, scale, shift, k,
                                                  slope),
                lambda: bn.batch_norm_backward_dx_plain(dy, x, scale, shift, k,
                                                        slope),
                library_backward, 3 * nbytes(x) + table + nbytes(k)),
        }

        def magnitudes(name):
            """The sums' band: the sum of their terms' magnitudes."""
            if name == "batch_norm_stats":
                return bn.batch_norm_stats_plain(x.abs())
            gp = bn._g(dy, x, scale, shift, slope).abs()
            dims = (2, 3) if per_row else (0, 2, 3)
            return torch.stack([gp.sum(dim=dims), (gp * x.float().abs()).sum(
                dim=dims)]).reshape(2, *scale.shape)

        for name, (kernel, plain, library, moved) in kernels.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if got.dtype == torch.bfloat16:
                err = (got.float() - want.float()).abs()
                ok = bool((err <= 2.0 ** -7 * want.float().abs() + 1e-5
                           * want.float().abs().max()).all())
            else:  # fp32 sums in another order
                ok = bool(((got - want).abs() <= 1e-5 * magnitudes(name)
                           ).all())
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version at {shape}, offset {offset}")
            del got, want
            row = {"shape": list(shape), "per_row_tables": per_row,
                   "slope": slope, "offset": offset,
                   "ms": time_ms(kernel, 7, 5),
                   "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                   "plain_ms": time_ms(plain, 3, 1),
                   "library_ms": time_ms(library, 7, 5)}
            entries[name]["sites"].append(row)
            tables = "per-row" if per_row else "per-channel"
            form = ", element-wise form" if offset else ""
            print(f"  {name} bf16 {shape} ({tables} tables, slope {slope}"
                  f"{form}): kernel {row['ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms (bytes, "
                  f"{100 * row['bound_ms'] / row['ms']:.0f}%), plain "
                  f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f}"
                  " ms", flush=True)
        del x, dy, storage
        torch.cuda.empty_cache()
    return entries


def check_kernels(device) -> dict:
    specs = kernel_specs(device)
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
                site = measure_site(name, spec, shape, site_dtype)
                row["max_abs_err"] = max(row["max_abs_err"],
                                         site["max_abs_err"])
                for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                    row[key] += site[key]
                bytes_s += site["bytes_ms"]
                flops_s += site["flops_ms"]
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
    # the Trainers' generates: validation batches, the grid at 49
    for name in ("pooled_kv_attention", "max_pool_2x2", "upsample_2x"):
        for batch in generate_batches():
            for dtype in DTYPES:
                hold_sites(specs, name, specs[name]["sites"](dtype, batch),
                           f"{str(dtype)[6:]} generate batch {batch}")
    # phase 14's selftest: the VGG-16 eval batches of its accuracies, in the
    # classifier's default float32
    hold_sites(specs, "max_pool_2x2",
               [(shape, torch.float32) for shape in vgg_pools(EV_BATCH)],
               f"float32 selftest VGG eval batch {EV_BATCH}")
    # every train step the smoke drives, per rank (the train step's own
    # sites: the loss pools in fp32, each backward)
    for batch, dtype in train_site_batches():
        for name, spec in specs.items():
            hold_sites(specs, name, spec["train_sites"](dtype, batch),
                       f"{str(dtype)[6:]} train step batch {batch}")
    # phase 11's fused D pass: D's attention and KV pool over real ++ fake
    for rows, dtype in fused_d_site_batches():
        what = f"{str(dtype)[6:]} fused-D pass of {rows} rows"
        hold_sites(specs, "pooled_kv_attention",
                   attention_sites(dtype, rows), what)
        for name in ("max_pool_2x2", "max_pool_2x2_backward"):
            hold_sites(specs, name, [(kv_pool(rows), dtype)], what)
    torch.cuda.empty_cache()
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
                want = dict(GENERATE_LAUNCHES,
                            max_pool_2x2=5 * vgg_forwards + 1)
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
            want = (TRAIN_LAUNCHES if dtype == "bfloat16"
                    else FP32_TRAIN_LAUNCHES)
            if delta != want:
                raise AssertionError(f"train step launches {delta}, expected "
                                     f"{want}")
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
    import copy
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
    for name in ("validate", "inference", "save_checkpoint"):
        setattr(first, name, clock.wrap(name, getattr(first, name)))
    # validate() and the grid sample through the family: time a copy of it
    # (the family object is shared by every Trainer of its model)
    first.family = copy.copy(first.family)
    first.family.sample = clock.wrap("generate", first.family.sample)
    fid_eval = first.fid_evaluator
    reduce_moments = fid_eval.reduce_moments
    fid_eval.moments = clock.wrap("inception", fid_eval.moments)
    fid_eval.reduce_moments = clock.wrap("host statistics",
                                         fid_eval.reduce_moments)
    sec = clock.seconds
    # phase 10 (d) validates again over NCCL from what G and the eval
    # generator hold before the last validation
    before_validation: dict = {}
    timed_validate = first.validate

    def validate():
        before_validation.update(
            rng=first.rng.get_state(),
            generator={k: v.clone() for k, v in
                       first.state.generator.state_dict().items()})
        return timed_validate()

    first.validate = validate
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
    n, totals = fid_eval.last_moments  # the last validation's
    fid_host = metrics["fid"][-1]
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
    return {"images_per_s": images_per_s, "counts": counts,
            "validation": dict(before_validation, val_set=val_set, n=n,
                               totals=totals, fid_device=fid_device)}


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
    "max_pool_2x2_backward": 5, "upsample_2x_backward": 0, **NO_BATCH_NORMS}
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
    """(d) The modules reader at full width: write phase 5's bf16 modules
    with buckets (1, 16), take the programs out of the manifest (as a JAX
    artifact lists none), read the artifact back with load_artifact, which
    must give the modules reader, and serve the same requests from both."""
    import os
    import shutil
    import tempfile

    from semantic_pyramid_for_image_generation_torch.serving.export import (
        ServingArtifact,
        save_artifact,
    )
    from semantic_pyramid_for_image_generation_torch.serving.program import (
        MANIFEST,
        load_artifact,
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
        with open(os.path.join(workdir, MANIFEST)) as f:
            manifest = json.load(f)
        with open(os.path.join(workdir, MANIFEST), "w") as f:
            json.dump(dict(manifest, programs=[]), f)
        t0 = time.perf_counter()
        artifact = load_artifact(workdir, device)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        if type(artifact) is not ServingArtifact:
            raise AssertionError(f"load_artifact read an artifact without "
                                 f"programs with {type(artifact).__name__}")
        read = GenerateService(artifact)
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
    print(f"  (d) {card}: artifact written in {write_s:.2f} s (weights.npz "
          f"{size:,} bytes), its programs taken out of the manifest, read "
          f"by the modules reader in {read_s:.2f} s; requests "
          f"{[r[:2] for r in REQUESTS[:2]]} from it against the in-memory "
          f"modules: max |difference| {errs} (tolerance 0: the same "
          f"weights, the same kernels)", flush=True)
    if max(errs) > 0.0:
        raise AssertionError("the artifact's output differs")


def profile_summary(label: str, run) -> None:
    """torch.profiler over one call of `run` (warm): wall time, device busy
    time and share, the port kernels' share of busy, the top 8 device ops."""
    from torch.profiler import ProfilerActivity, profile

    from semantic_pyramid_for_image_generation_torch.scripts import (
        profile_step,
    )

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
               if any(k in name for k in profile_step.KERNEL_NAMES))
    print(f"  profile {label}: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(kernels)} "
          f"device ops, port kernels {ours:.3f} ms "
          f"({100 * ours / max(busy_ms, 1e-9):.1f}% of busy)")
    split: dict = {}
    for name, t in by_name.items():
        kind = profile_step.category(name)
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


# --------------------------------------------------------------- phase 10 --


DP_WORLD = 2  # gloo ranks sharing the one card
DP_BF16_BATCH = 64  # global: 32 rows per rank
DP_BF16_STEPS = 3
DP_FP32_BATCH = 16  # global: 8 rows per rank
DP_FP32_STEPS = 2
DP_SEEDS = (SEED, SEED + 1, SEED + 2)  # (b) and (c) run on each
DP_FAULTS = ("bn_local", "diversity_local", "projection_local",
             "grads_averaged")
# the hold of (b): ROADMAP Queue 3's rule, plus the gradients (Adam divides
# out most of their scale) and the projection's embedding gradient. Each
# limit is the larger of its floor here and DP_WITNESS_FACTOR times the
# witness's reading: one process stepping the same rows with each half
# reversed, the same arithmetic in another summation order (at full width
# fp32 noise alone puts 0.3-0.7% of G's elements past 1% of an Adam step).
# Over seeds 0-2 (PERF.md, PR 7) the two ranks read at most 2.06x the
# witness in G's elements off, the faults that move G at least 18.5x: the
# factor sits near their geometric middle, ~3x from each. The embedding's
# floor sits likewise between the sound runs (<= 1.3e-7) and the local
# projection rows (>= 1.8e-3), which the metrics miss on seed 1.
DP_LIMITS = {"metrics": 1e-4, "generator_off": 1e-3, "discriminator_off": 1e-3,
             "generator_grads": 1e-3, "discriminator_grads": 1e-3,
             "embedding_grads": 1e-5}
DP_WITNESS_FACTOR = 6
DP_TIMEOUT_S = 300
NCCL_BATCH = 64
NCCL_STEPS = 4


def parallel_helpers():
    """tests/torch_parallel_rank.py (JAX-free): the row helpers, planted
    faults and readings that the CPU tests hold the ranks with."""
    import importlib.util
    import os

    name = "torch_parallel_rank"
    if name not in sys.modules:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "torch_parallel_rank.py")
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def reversed_halves(batch: dict) -> dict:
    """The batch with each half's rows reversed: the diversity loss pairs
    the same rows (i with i + B/2), and every other reduction over the batch
    is a sum, so the step computes the same in another summation order."""
    half = batch["images"].shape[0] // 2
    order = np.arange(2 * half).reshape(2, half)[:, ::-1].reshape(-1)
    return parallel_helpers().rows_of(batch, order)


def dp_reference(device, workdir: str, seed: int,
                 mode: str = "default") -> dict:
    """(b)'s reference for one seed, in this process without a group: a
    full-width fp32 state from `seed` (u/v advanced 10 iterations) steps the
    global batches of 16 with pinned latents, in perf mode `mode`
    (PERF_MODES; phase 11 (f)). The initial state and the batches go to
    `<mode>_inputs<seed>.pt` for the ranks; the metrics, the first step's
    gradients and the final G and D to `<mode>_reference<seed>.pt`. Then
    the witness steps the same rows with each half reversed from the same
    state; its readings against the reference are returned."""
    import os

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
        make_optimizers,
    )
    from semantic_pyramid_for_image_generation_torch.train.step import (
        batch_to_device,
        make_train_step,
    )

    h = parallel_helpers()
    fields, flags = h.PERF_MODES[mode]
    config = PyramidGANConfig(compute_dtype="float32", **fields)
    state = init_train_state(config, device, lr=LR, seed=seed)
    for net in (state.generator, state.discriminator):
        advance_spectral_norm_(net, 10)
    rng = np.random.default_rng(seed + 10)
    batches = []
    for _ in range(DP_FP32_STEPS):
        batch = synthetic_batch(config, DP_FP32_BATCH, rng)
        for key in ("noise_d", "noise_g"):
            batch[key] = rng.standard_normal(
                (DP_FP32_BATCH, config.latent_dim)).astype(np.float32)
        batches.append(batch)
    inputs = {"batches": batches}
    for net in ("generator", "discriminator", "vgg"):
        inputs[net] = h.to_cpu(getattr(state, net).state_dict())
    torch.save(inputs, os.path.join(workdir, f"{mode}_inputs{seed}.pt"))
    step = make_train_step(**flags)
    runs = []
    for rows in (lambda b: b, reversed_halves):
        for net in ("generator", "discriminator"):
            getattr(state, net).load_state_dict(inputs[net])
        state.g_optimizer, state.d_optimizer = make_optimizers(
            state.generator, state.discriminator, LR)
        run = {"metrics": []}
        for batch in batches:
            _, m = step(state, batch_to_device(rows(batch), device))
            run["metrics"].append({k: float(v) for k, v in m.items()})
            run.setdefault("grads", h.gradients(state))
        for net in ("generator", "discriminator"):
            run[net] = h.to_cpu(getattr(state, net).state_dict())
        runs.append(run)
    torch.save(runs[0], os.path.join(workdir, f"{mode}_reference{seed}.pt"))
    return h.readings_against(runs[1], runs[0], LR)


def broken(readings: dict, limits: dict) -> list:
    return [k for k, limit in limits.items() if not readings[k] <= limit]


def dp_bf16_steps(device) -> dict:
    """(a): full-width bf16 from SEED, broadcast from rank 0, 3 steps of this
    rank's 32 rows of global batches of 64; launches, ms and collective
    bytes per step, and the state's digest after."""
    from semantic_pyramid_for_image_generation_torch.data.synthetic import (
        synthetic_batch,
    )
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
    from semantic_pyramid_for_image_generation_torch.parallel import mesh
    from semantic_pyramid_for_image_generation_torch.train.step import (
        batch_to_device,
        make_train_step,
    )

    rows_of = parallel_helpers().rows_of
    state = trainer_state(device)
    mesh.broadcast_state(state)
    rows = mesh.shard_slice(DP_BF16_BATCH, DP_WORLD, mesh.rank())
    rng = np.random.default_rng(SEED)
    batches = [batch_to_device(rows_of(synthetic_batch(
        state.generator.config, DP_BF16_BATCH, rng), rows), device)
        for _ in range(DP_BF16_STEPS)]
    step = make_train_step()
    latents = torch.Generator(device).manual_seed(SEED)
    steps = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for batch in batches:
        before, sent = kernels.launch_counts(), dict(mesh.collective_bytes)
        t0 = time.perf_counter()
        _, metrics = step(state, batch, latents)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = kernels.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        if delta != TRAIN_LAUNCHES:
            raise AssertionError(f"rank {mesh.rank()} step launches {delta}")
        values = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in values.values()):
            raise AssertionError(f"non-finite losses {values}")
        steps.append({"ms": ms, "launches": delta, "metrics": values,
                      "bytes": {k: mesh.collective_bytes[k] - sent[k]
                                for k in sent}})
    return {"steps": steps, "launches": kernels.launch_counts(),
            "digest": mesh.state_digest(state),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def dp_fp32_runs(device, workdir: str, mode: str = "default",
                 seeds=DP_SEEDS, runs=("sound", *DP_FAULTS)) -> dict:
    """(b) and (c) for each seed: the sound fp32 run and one run per planted
    fault, each from the seed's initial state, 2 steps of this rank's 8
    rows in perf mode `mode`; each run's digest and collective bytes, and
    on rank 0 its readings against the seed's reference."""
    import os

    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.parallel import mesh
    from semantic_pyramid_for_image_generation_torch.train.state import (
        init_train_state,
        make_optimizers,
    )
    from semantic_pyramid_for_image_generation_torch.train.step import (
        batch_to_device,
        make_train_step,
    )

    h = parallel_helpers()
    fields, flags = h.PERF_MODES[mode]
    state = init_train_state(PyramidGANConfig(compute_dtype="float32",
                                              **fields), device, lr=LR)
    rows = mesh.shard_slice(DP_FP32_BATCH, DP_WORLD, mesh.rank())
    step = make_train_step(**flags)
    out = {}
    for seed in seeds:
        inputs = torch.load(os.path.join(workdir, f"{mode}_inputs{seed}.pt"),
                            weights_only=False)
        ref = torch.load(os.path.join(workdir, f"{mode}_reference{seed}.pt"),
                         weights_only=False) if mesh.rank() == 0 else None
        state.vgg.load_state_dict(inputs["vgg"])
        batches = [batch_to_device(h.rows_of(b, rows), device)
                   for b in inputs["batches"]]
        out[seed] = {}
        for run in runs:
            for net in ("generator", "discriminator"):
                getattr(state, net).load_state_dict(inputs[net])
            state.g_optimizer, state.d_optimizer = make_optimizers(
                state.generator, state.discriminator, LR)
            state.step = 0
            mesh.broadcast_state(state)
            sent = dict(mesh.collective_bytes)
            got = {"metrics": []}
            with h.planted(run):
                for batch in batches:
                    _, m = step(state, batch)
                    got["metrics"].append({k: float(v) for k, v in m.items()})
                    got.setdefault("grads", h.gradients(state))
            out[seed][run] = {
                "digest": mesh.state_digest(state),
                "bytes": {k: mesh.collective_bytes[k] - sent[k] for k in sent}}
            if ref is not None:
                for net in ("generator", "discriminator"):
                    got[net] = h.to_cpu(getattr(state, net).state_dict())
                out[seed][run]["readings"] = h.readings_against(got, ref, LR)
    return out


def dp_rank(rank: int, workdir: str, port: int) -> None:
    """One gloo rank of phase 10 on cuda:0 (spawned): (a), then (b) and (c);
    its results to `<workdir>/rank<r>.json`."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_WORLD),
                      LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    from semantic_pyramid_for_image_generation_torch.parallel import mesh

    device = mesh.init_distributed("cuda", backend="gloo")
    out = {"bf16": dp_bf16_steps(device)}
    torch.cuda.empty_cache()
    out["fp32"] = dp_fp32_runs(device, workdir)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    mesh.shutdown_distributed()


def drive_gloo_ranks(device, card: str) -> dict:
    """(a)-(c): the reference in this process, then two spawned gloo ranks
    on cuda:0, joined within DP_TIMEOUT_S (killed and failed past it)."""
    import os
    import shutil
    import tempfile

    workdir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    t0 = time.perf_counter()
    witness = {}
    for seed in DP_SEEDS:
        witness[seed] = dp_reference(device, workdir, seed)
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    spawn_ranks(dp_rank, workdir)
    ranks = []
    for r in range(DP_WORLD):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(workdir)
    ranks_s = time.perf_counter() - t0 - ref_s

    bf16 = [r["bf16"] for r in ranks]
    if len({r["digest"] for r in bf16}) != 1:
        raise AssertionError("(a) the ranks' states differ after the steps")
    for r, run in enumerate(bf16):
        ms = [round(s["ms"], 2) for s in run["steps"]]
        print(f"  (a) {card}: rank {r}, bf16, {DP_BF16_BATCH // DP_WORLD} "
              f"of {DP_BF16_BATCH} rows: ms per step "
              f"{ms}; launches per step {run['steps'][-1]['launches']} "
              f"(all {DP_BF16_STEPS} steps exact); collective bytes per "
              f"step {run['steps'][-1]['bytes']}; peak "
              f"{run['peak_gib']:.2f} GiB", flush=True)
    print(f"  (a) G, D, Adam moments, u/v and running statistics bitwise "
          f"equal on both ranks (sha256 {bf16[0]['digest'][:16]}); last "
          f"losses {bf16[0]['steps'][-1]['metrics']}. Two ranks sharing one "
          f"card over gloo: a check of the arithmetic, not a multi-card "
          f"speed", flush=True)
    print(f"  (b) fp32, {DP_WORLD} ranks x {DP_FP32_BATCH // DP_WORLD} rows "
          f"vs one process on the {DP_FP32_BATCH}, {DP_FP32_STEPS} steps, "
          f"seeds {list(DP_SEEDS)}; witness: one process on the same rows "
          f"with each half reversed; limits, the larger of {DP_LIMITS} and "
          f"{DP_WITNESS_FACTOR}x the witness", flush=True)
    ratios = {"sound": []}
    for seed in DP_SEEDS:
        w = witness[seed]
        limits = {k: max(floor, DP_WITNESS_FACTOR * w[k])
                  for k, floor in DP_LIMITS.items()}
        runs = [r["fp32"][str(seed)] for r in ranks]
        if runs[0]["sound"]["digest"] != runs[1]["sound"]["digest"]:
            raise AssertionError(f"(b) seed {seed}: the ranks' states differ")
        sound = runs[0]["sound"]["readings"]
        print(f"  (b) seed {seed}: witness {w}", flush=True)
        print(f"  (b) seed {seed}: two ranks {sound}; ranks bitwise equal",
              flush=True)
        if broken(sound, limits):
            raise AssertionError(f"(b) seed {seed}: the two ranks break "
                                 f"{broken(sound, limits)}")
        ratios["sound"].append(sound["generator_off"] / w["generator_off"])
        for fault in DP_FAULTS:
            readings = runs[0][fault]["readings"]
            ratios.setdefault(fault, []).append(
                readings["generator_off"] / w["generator_off"])
            print(f"  (c) seed {seed}, planted {fault}: breaks "
                  f"{broken(readings, limits)}; readings {readings}",
                  flush=True)
            if not broken(readings, limits):
                raise AssertionError(f"(c) seed {seed}: the hold missed "
                                     f"{fault}")
    print(f"  (b)-(c) G's elements off over the witness's, per seed: "
          f"{ {k: [round(x, 3) for x in v] for k, v in ratios.items()} } "
          f"(beside the factor {DP_WITNESS_FACTOR})", flush=True)
    print(f"  (a)-(c): references {ref_s:.1f} s, ranks {ranks_s:.1f} s",
          flush=True)
    return {"launches": bf16[0]["launches"],
            "ms": [s["ms"] for s in bf16[0]["steps"]]}


def drive_nccl_trainer(device, card: str, phase7: dict,
                       step_ms_16: float) -> None:
    """(d): one rank over NCCL in this process. bf16 bare steps at batch 64
    timed without a group and then in a one-rank NCCL group; the Trainer at
    batch 64 in that group: 4 steps, the epoch-end grid and checkpoint, and
    one validation from G and the eval generator as phase 7's last
    validation had them, on phase 7's batches: the same moments and FID."""
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
    from semantic_pyramid_for_image_generation_torch.parallel import mesh
    from semantic_pyramid_for_image_generation_torch.train.loop import Trainer
    from semantic_pyramid_for_image_generation_torch.train.step import (
        make_train_step,
    )

    state = trainer_state(device)
    config = state.generator.config
    batches = train_batches(config, NCCL_BATCH, NCCL_STEPS, device)
    step = make_train_step()
    latents = torch.Generator(device).manual_seed(SEED)

    def timed():
        times = []
        for batch in batches[1:]:
            t0 = time.perf_counter()
            step(state, batch, latents)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    step(state, batches[0], latents)  # first at this shape
    torch.cuda.synchronize()
    bare = timed()
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(parallel_helpers().free_port()))
    rank_device = mesh.init_distributed("cuda")
    if rank_device != torch.device("cuda", 0) or \
            torch.distributed.get_backend() != "nccl":
        raise AssertionError(f"the one-rank group is "
                             f"{torch.distributed.get_backend()} on "
                             f"{rank_device}, not NCCL on cuda:0")
    mesh.reset_collective_bytes()
    grouped = timed()
    sent = {k: v // len(grouped) for k, v in mesh.collective_bytes.items()}
    del state, batches
    torch.cuda.empty_cache()

    has_pil = importlib.util.find_spec("PIL") is not None
    rng = np.random.default_rng(SEED)
    train_set = [synthetic_batch(config, NCCL_BATCH, rng)
                 for _ in range(NCCL_STEPS)]
    workdir = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-init FID warning
        trainer = Trainer(config, train_set, phase7["val_set"], lr=LR,
                          device=device, save_data_path=workdir, seed=SEED,
                          state=trainer_state(device), allow_random_fid=True,
                          fid_device_stats=True, write_grids=has_pil)
    laps = []
    train_step = trainer.train_step

    def lap(batch):
        t0 = time.perf_counter()
        out = train_step(batch)
        torch.cuda.synchronize()
        laps.append((time.perf_counter() - t0) * 1e3)
        return out

    trainer.train_step = lap
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    trainer.train(epochs=1, validate_after_n_iterations=10 ** 9,
                  validate_at_start=False, progress=False)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {k: NCCL_STEPS * TRAIN_LAUNCHES[k] + GENERATE_LAUNCHES[k]
            for k in counts}
    if counts != want:
        raise AssertionError(f"(d) Trainer launches {counts}, expected {want}")
    (ckpt,) = glob.glob(os.path.join(trainer.paths["models"], "*.pt"))
    grid = trainer.last_grid
    if grid.shape != (49, 256, 256, 3) or not np.isfinite(grid).all():
        raise AssertionError(f"(d) grid {grid.shape}")
    trainer.state.generator.load_state_dict(phase7["generator"])
    trainer.rng.set_state(phase7["rng"])
    fid = trainer.validate()
    n, totals = trainer.fid_evaluator.last_moments
    diff = max(float((a - b).abs().max())
               for a, b in zip(totals, phase7["totals"]))
    print(f"  (d) {card}: one rank over NCCL, bf16 batch {NCCL_BATCH}: bare "
          f"step without a group {[round(t, 2) for t in bare]} ms, in the "
          f"group {[round(t, 2) for t in grouped]} ms (collective bytes per "
          f"step {sent}; phase 6's bare step at batch {BATCH}: "
          f"{step_ms_16:.2f} ms); Trainer ms per step "
          f"{[round(t, 2) for t in laps]}; launches {counts} ({NCCL_STEPS} "
          f"steps, one grid); {os.path.basename(ckpt)} written; FID from "
          f"phase 7's last G and eval generator on its batches: {fid!r} "
          f"against phase 7's {phase7['fid_device']!r} (device float32 "
          f"eigh), n {n}, moments max |difference| {diff:.3g}", flush=True)
    if n != phase7["n"] or diff != 0.0 or fid != phase7["fid_device"]:
        raise AssertionError("(d) the NCCL Trainer's FID differs from "
                             "phase 7's")
    shutil.rmtree(workdir)
    mesh.shutdown_distributed()

# --------------------------------------------------------------- phase 11 --


PM_TIMED = ("default", "canonical", "fused_d", "remat_vgg", "remat_blocks",
            "all")  # (a)
PM_BATCH = 64  # (a): full-width bf16 steps
PM_STEPS = 6  # (a): 1 warm-up + 5 timed
PM_FP32_BATCH = 8  # (c), (d): full-width fp32 holds
PM_HOLD_STEPS = 2  # (c)
PM_FUSED_STEPS = 3  # (d), as the JAX package's own claim runs it
PM_SEEDS = (SEED, SEED + 1, SEED + 2)  # (c) and (d) run on each
PM_REMAT_MODES = ("remat_vgg", "remat_blocks", "remat_both")  # (c)
PM_REMAT_FAULTS = ("recompute_unguarded", "recompute_uv_unguarded",
                   "recompute_bn_twice")  # (c), planted in remat_blocks
PM_FUSED_FAULTS = ("fused_labels_shifted", "fused_uv_advanced")  # (d)
PM_CLI_BATCH = BATCH  # (e): two steps of 16 rows
PM_GLOO_MODE = "fused_d_remat_blocks"  # (f)
# (c) and (d): each limit is the larger of its floor here and
# PM_WITNESS_FACTOR times the seed's witness reading (`readings_against`:
# metrics, the share of each network's elements off, the first gradients,
# u/v, the running statistics). (c)'s witness is the default step run
# again (the remat modes run the same arithmetic; the card's fp32 step is
# not bitwise from run to run); (d)'s is the separate passes on each half
# of the batch reversed (the same arithmetic in another summation order,
# as phase 10's). (d) adds `real_loss`: the first step's real loss with
# spectral updates on, relative to the separate passes'; its u/v must be
# untouched (limit 0). Each floor sits near the geometric middle between
# the sound runs' largest reading and the smallest reading of the planted
# faults above them, over seeds 0-2 in three runs on the H100 (PERF.md, PR
# 8): (c) sound <= 5.8e-7 / 3.9e-4 / 1.8e-7 / 9.4e-7 / 1.1e-8 / 0 / 2.9e-7 /
# 7.3e-5 in the order below, faults >= 0.048 / 0.056 / 0.27 / 0.0082 /
# 0.0032 / (none) / 0.076 / 0.0013; (d) sound <= 3.3e-6 / 7.1e-4 / 1.7e-4 /
# 3.6e-6 / 1.2e-5 / 3e-7 / 0 / 8.3e-4 / 0, faults >= 0.041 / - / 0.021 / - /
# 5.2e-5 / 4.1e-4 / 0.070 / - / 1.8e-5 ("-": no fault moves it past the
# sound runs; its floor sits above them and the witness sets the limit).
PM_REMAT_LIMITS = {"metrics": 1e-4, "generator_off": 4e-3,
                   "discriminator_off": 1e-3, "generator_grads": 1e-4,
                   "discriminator_grads": 1e-5, "embedding_grads": 1e-5,
                   "uv": 1e-4, "bn": 3e-4}
PM_FUSED_LIMITS = {"metrics": 3e-4, "generator_off": 1e-3,
                   "discriminator_off": 2e-3, "generator_grads": 1e-4,
                   "discriminator_grads": 3e-5, "embedding_grads": 1e-5,
                   "uv": 0.0, "bn": 2e-3, "real_loss": 3e-6}
PM_WITNESS_FACTOR = DP_WITNESS_FACTOR


def set_perf_mode(state, mode: str) -> dict:
    """Give `state`'s G and D the config fields of perf mode `mode` (the
    forward reads `compat_projection` and `remat_blocks` at each call) and
    return its make_train_step flags."""
    fields, flags = parallel_helpers().PERF_MODES[mode]
    config = dataclasses.replace(state.generator.config, **{
        "compat_projection": True, "remat_blocks": False, **fields})
    state.generator.config = state.discriminator.config = config
    return flags


def reset_state(state, initial: dict) -> None:
    """G and D back to `initial` (state dicts), fresh Adam, step 0."""
    from semantic_pyramid_for_image_generation_torch.train.state import (
        make_optimizers,
    )

    for net in ("generator", "discriminator"):
        getattr(state, net).load_state_dict(initial[net])
    state.g_optimizer, state.d_optimizer = make_optimizers(
        state.generator, state.discriminator, LR)
    state.step = 0


def pinned_batches(config, batch: int, n: int, seed: int = SEED):
    """`n` synthetic numpy batches with pinned latents."""
    from semantic_pyramid_for_image_generation_torch.data.synthetic import (
        synthetic_batch,
    )

    rng = np.random.default_rng(seed + 20)
    out = []
    for _ in range(n):
        b = synthetic_batch(config, batch, rng)
        for key in ("noise_d", "noise_g"):
            b[key] = rng.standard_normal(
                (batch, config.latent_dim)).astype(np.float32)
        out.append(b)
    return out


def drive_perf_modes(device, card: str) -> dict:
    """(a) Full-width bf16 steps at batch 64 from one state, in each mode of
    PM_TIMED: 1 warm-up and 5 timed steps; launch deltas exactly
    PERF_MODE_LAUNCHES per step; median ms and spread, peak GiB."""
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
    from semantic_pyramid_for_image_generation_torch.train.step import (
        make_train_step,
    )

    launches = parallel_helpers().PERF_MODE_LAUNCHES
    state = trainer_state(device)
    initial = {net: {k: v.clone() for k, v in
                     getattr(state, net).state_dict().items()}
               for net in ("generator", "discriminator")}
    batches = train_batches(state.generator.config, PM_BATCH, PM_STEPS, device)
    latents = torch.Generator(device).manual_seed(SEED)
    results, per_step = {}, {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for mode in PM_TIMED:
        step = make_train_step(**set_perf_mode(state, mode))
        reset_state(state, initial)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for batch in batches:
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            _, metrics = step(state, batch, latents)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            after = kernels.launch_counts()
            delta = {k: after[k] - before[k] for k in after}
            if delta != launches[mode]:
                raise AssertionError(f"(a) {mode}: launches per step {delta}, "
                                     f"expected {launches[mode]}")
            values = {k: float(v) for k, v in metrics.items()}
            if not all(np.isfinite(v) for v in values.values()):
                raise AssertionError(f"(a) {mode}: non-finite losses {values}")
        timed = times[1:]
        results[mode] = {
            "ms_per_step": statistics.median(timed),
            "spread_ms": [min(timed), max(timed)],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        per_step[mode] = delta
        print(f"  (a) {card}: {mode}, bf16 batch {PM_BATCH}: "
              f"{results[mode]['ms_per_step']:.2f} ms/step median of "
              f"{len(timed)} (spread {min(timed):.2f}-{max(timed):.2f}; first "
              f"{times[0]:.1f}), {PM_BATCH * 1e3 / results[mode]['ms_per_step']:.1f}"
              f" images/s, peak {results[mode]['peak_gib']:.2f} GiB, launches "
              f"per step {delta}", flush=True)
    counts = kernels.launch_counts()
    state.generator.config = state.discriminator.config = dataclasses.replace(
        state.generator.config, compat_projection=True, remat_blocks=False)
    del state, batches, initial
    torch.cuda.empty_cache()
    return {"launches": counts, "per_step": per_step, "results": results}


def fp32_hold_state(device, seed: int):
    """A full-width fp32 state from `seed`, u/v advanced 10 iterations, and
    a copy of its G and D state dicts on the card."""
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.models.layers import (
        advance_spectral_norm_,
    )
    from semantic_pyramid_for_image_generation_torch.train.state import (
        init_train_state,
    )

    state = init_train_state(PyramidGANConfig(compute_dtype="float32"),
                             device, lr=LR, seed=seed)
    for net in (state.generator, state.discriminator):
        advance_spectral_norm_(net, 10)
    initial = {net: {k: v.clone() for k, v in
                     getattr(state, net).state_dict().items()}
               for net in ("generator", "discriminator")}
    return state, initial


def pm_run(state, initial: dict, batches, mode: str,
           spectral_update: bool = True) -> dict:
    """`state` from `initial` through the numpy `batches` in perf mode
    `mode`: the metrics per step, the first step's gradients, G and D."""
    from semantic_pyramid_for_image_generation_torch.train.step import (
        batch_to_device,
        make_train_step,
    )

    h = parallel_helpers()
    device = next(state.generator.parameters()).device
    step = make_train_step(spectral_update=spectral_update,
                           **set_perf_mode(state, mode))
    reset_state(state, initial)
    run = {"metrics": []}
    for batch in batches:
        _, m = step(state, batch_to_device(batch, device))
        run["metrics"].append({k: float(v) for k, v in m.items()})
        run.setdefault("grads", h.gradients(state))
    for net in ("generator", "discriminator"):
        run[net] = h.to_cpu(getattr(state, net).state_dict())
    return run


def remat_readings(state, initial: dict, batches) -> dict:
    """(c) on one seed: the witness (the default step again), each remat
    mode and each planted recompute fault, against the default step."""
    h = parallel_helpers()
    ref = pm_run(state, initial, batches, "default")
    out = {"witness": h.readings_against(
        pm_run(state, initial, batches, "default"), ref, LR)}
    for mode in PM_REMAT_MODES:
        out[mode] = h.readings_against(pm_run(state, initial, batches, mode),
                                       ref, LR)
    for fault in PM_REMAT_FAULTS:
        with h.planted(fault):
            out[fault] = h.readings_against(
                pm_run(state, initial, batches, "remat_blocks"), ref, LR)
    return out


def fused_readings(state, initial: dict, batches) -> dict:
    """(d) on one seed: the witness (the separate passes on each half of
    every batch reversed), fused_d and each planted fused-pass fault,
    against the separate passes, all with spectral updates frozen; each
    with `real_loss`, its first step's real loss with updates on against
    the separate passes'."""
    h = parallel_helpers()

    def real_loss(mode, rows):
        return pm_run(state, initial, [rows(batches[0])], mode)["metrics"][
            0]["loss_discriminator_real"]

    ref = pm_run(state, initial, batches, "canonical", spectral_update=False)
    untouched = all(torch.equal(ref[net][k], initial[net][k].cpu())
                    for net in ("generator", "discriminator")
                    for k in initial[net] if k.endswith(("weight_u",
                                                         "weight_v")))
    if not untouched:
        raise AssertionError("(d) the separate passes moved u/v with "
                             "spectral updates frozen")
    ref_real = real_loss("canonical", lambda b: b)
    runs = {"witness": ("canonical", reversed_halves, "sound"),
            "fused_d": ("fused_d", lambda b: b, "sound")}
    runs.update({f: ("fused_d", lambda b: b, f) for f in PM_FUSED_FAULTS})
    out = {}
    for name, (mode, rows, fault) in runs.items():
        with h.planted(fault):
            got = pm_run(state, initial, [rows(b) for b in batches], mode,
                         spectral_update=False)
            real = real_loss(mode, rows)
        out[name] = h.readings_against(got, ref, LR)
        out[name]["real_loss"] = abs(real - ref_real) / abs(ref_real)
    return out


def limits_of(floors: dict, witness: dict) -> dict:
    return {k: max(floor, PM_WITNESS_FACTOR * witness[k])
            for k, floor in floors.items()}


def check_perf_mode_holds(device, card: str) -> None:
    """(c) and (d) on each seed of PM_SEEDS, every reading printed before
    any check: each sound run (the remat modes; fused_d) within its seed's
    limits, each planted fault breaking them on every seed. Then, per
    limit, the sound runs' largest reading and the smallest of the faults'
    readings above it: a floor between the two separates them."""
    parts = {"c": (remat_readings, PM_HOLD_STEPS, PM_REMAT_LIMITS,
                   PM_REMAT_MODES, PM_REMAT_FAULTS),
             "d": (fused_readings, PM_FUSED_STEPS, PM_FUSED_LIMITS,
                   ("fused_d",), PM_FUSED_FAULTS)}
    failures, seen = [], {part: [] for part in parts}
    for seed in PM_SEEDS:
        state, initial = fp32_hold_state(device, seed)
        batches = pinned_batches(state.generator.config, PM_FP32_BATCH,
                                 PM_FUSED_STEPS, seed)
        for part, (readings_of, steps, floors, sound, faults) in parts.items():
            readings = readings_of(state, initial, batches[:steps])
            limits = limits_of(floors, readings["witness"])
            print(f"  ({part}) {card}: seed {seed}, fp32 batch "
                  f"{PM_FP32_BATCH}, {steps} steps; limits {fmt(limits)}",
                  flush=True)
            for name, r in readings.items():
                over = broken(r, limits)
                print(f"    {name}: {fmt(r)}; over {over}", flush=True)
                if name in sound and over:
                    failures.append(f"({part}) seed {seed}: {name} breaks "
                                    f"{over}")
                if name in faults and not over:
                    failures.append(f"({part}) seed {seed}: the hold missed "
                                    f"{name}")
                seen[part].append((name, r))
        set_perf_mode(state, "default")
        del state, initial
        torch.cuda.empty_cache()
    for part, (_, _, floors, sound, faults) in parts.items():
        for k, floor in floors.items():
            top = max(r[k] for name, r in seen[part] if name in sound)
            above = [r[k] for name, r in seen[part]
                     if name in faults and r[k] > top]
            print(f"  ({part}) {k}: sound runs <= {top:.3g}, faults above "
                  f"them >= {min(above, default=float('nan')):.3g} "
                  f"({len(above)} of {len(PM_SEEDS) * len(faults)}), floor "
                  f"{floor:.3g}", flush=True)
    if failures:
        raise AssertionError("; ".join(failures))


def fmt(readings: dict) -> str:
    return "{" + ", ".join(f"{k}: {v:.3g}" for k, v in readings.items()) + "}"


def write_places_tree(root: str, n_train: int, n_val: int) -> None:
    """A Places365 tree (`<root>/{train,val}/<class>/<i>.jpg` and the split
    files) of random 256x256 JPEGs from SEED, two classes."""
    import os

    from PIL import Image

    rng = np.random.default_rng(SEED)
    for split, n in (("train", n_train), ("val", n_val)):
        lines = []
        for c in ("abbey", "zoo"):
            os.makedirs(os.path.join(root, split, c))
            for i in range(n // 2):
                Image.fromarray(rng.integers(0, 256, (256, 256, 3),
                                             dtype=np.uint8)).save(
                    os.path.join(root, split, c, f"{i}.jpg"))
                lines.append(f"{split}/{c}/{i}.jpg")
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def drive_perf_mode_cli(device, card: str) -> None:
    """(e) cli/main.py at full width on a JPEG Places365 tree: `--train
    --fused_d --remat_vgg --remat_blocks` takes 2 steps of PM_CLI_BATCH in
    bf16, validates on one batch of twice that and writes
    checkpoint_000.pt; a default-mode run resumes from it with
    --load_checkpoint and takes 2 more. Each run's backward launches are 2
    steps of its mode's (its generates launch none). Phase 3 holds the
    kernels at these train, fused-D and generate sites."""
    import contextlib
    import glob
    import io
    import os
    import shutil
    import tempfile
    import warnings

    from semantic_pyramid_for_image_generation_torch.cli import main as cli
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels

    launches = parallel_helpers().PERF_MODE_LAUNCHES
    workdir = tempfile.mkdtemp(prefix="chip_smoke_perf_cli_")
    try:
        root = os.path.join(workdir, "places")
        write_places_tree(root, 2 * PM_CLI_BATCH, 2 * PM_CLI_BATCH)
        common = ["--train", "--device", str(device), "--epochs", "1",
                  "--batch_size", str(PM_CLI_BATCH), "--path_to_places365", root,
                  "--fid_images", str(2 * PM_CLI_BATCH), "--num_workers", "4",
                  "--allow_random_fid", "--fid_device_stats",
                  "--validate_after_n_iterations", "1000000", "--log_every",
                  "1", "--load_pretrained_vgg16", ""]
        runs = (("all", ["--fused_d", "--remat_vgg", "--remat_blocks"]),
                ("default", []))
        ckpt, summary = None, []
        for mode, flags in runs:
            save = os.path.join(workdir, mode)
            argv = common + flags + ["--save_data_path", save]
            if ckpt is not None:
                argv += ["--load_checkpoint", ckpt]
            printed = io.StringIO()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(printed), \
                        contextlib.redirect_stderr(printed), \
                        warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    cli.main(argv)
            except BaseException:
                print(printed.getvalue()[-4000:], flush=True)
                raise
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = kernels.launch_counts()
            (ckpt,) = glob.glob(os.path.join(save, "models_*",
                                             "checkpoint_000.pt"))
            saved = torch.load(ckpt, map_location="cpu", weights_only=False)
            (metrics,) = glob.glob(os.path.join(save, "metrics_*"))
            losses = np.load(os.path.join(metrics, "loss_generator.npy"))
            want_step = 2 * len(summary) + 2
            for name in ("max_pool_2x2_backward", "upsample_2x_backward",
                         "batch_norm_backward_sums", "batch_norm_backward_dx"):
                if counts[name] != 2 * launches[mode][name]:
                    raise AssertionError(f"(e) {mode}: {name} launched "
                                         f"{counts[name]} times")
            if saved["step"] != want_step or len(losses) != 2 or \
                    not np.isfinite(losses).all():
                raise AssertionError(f"(e) {mode}: checkpoint step "
                                     f"{saved['step']}, losses {losses}")
            if summary and "Restored checkpoint" not in printed.getvalue():
                raise AssertionError("(e) the default-mode run did not resume")
            summary.append(f"{mode} {' '.join(flags) or '(no flags)'}: "
                           f"{seconds:.1f} s, checkpoint step "
                           f"{saved['step']}, loss_generator "
                           f"{[round(float(x), 4) for x in losses]}, "
                           f"launches {counts}")
            del saved
        print(f"  (e) {card}: the CLI at full width, 2 steps of "
              f"{PM_CLI_BATCH} per run (with validation at start and the "
              f"epoch-end grid and checkpoint): " + "; then ".join(summary),
              flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()


def pm_rank(rank: int, workdir: str, port: int) -> None:
    """One gloo rank of (f) on cuda:0 (spawned): the sound fp32 run of
    PM_GLOO_MODE from phase 10's seed, its launches; to
    `<workdir>/pm_rank<r>.json`."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_WORLD),
                      LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
    from semantic_pyramid_for_image_generation_torch.parallel import mesh

    device = mesh.init_distributed("cuda", backend="gloo")
    kernels.reset_launch_counts()
    out = dp_fp32_runs(device, workdir, mode=PM_GLOO_MODE, seeds=(SEED,),
                       runs=("sound",))[SEED]["sound"]
    out["launches"] = kernels.launch_counts()
    with open(os.path.join(workdir, f"pm_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    mesh.shutdown_distributed()


def spawn_ranks(fn, workdir: str) -> None:
    """DP_WORLD spawned processes of `fn(rank, workdir, port)`, joined within
    DP_TIMEOUT_S (killed and failed past it)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(workdir,
                                       parallel_helpers().free_port()),
                             nprocs=DP_WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + DP_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"the gloo ranks ran past {DP_TIMEOUT_S} s")


def drive_perf_mode_ranks(device, card: str) -> None:
    """(f) Two gloo ranks on cuda:0 in PM_GLOO_MODE (--fused_d
    --remat_blocks), fp32, 8 rows each of global batches of 16, 2 steps,
    against this process on the 16 under phase 10's limits and witness; the
    ranks bitwise equal; launches per rank 2 steps of the mode's; the bytes
    each rank all-reduces and gathers per step exactly as
    `step_collective_bytes` works them out."""
    import os
    import shutil
    import tempfile
    import types

    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.models.discriminator import (  # noqa: E501
        Discriminator,
    )
    from semantic_pyramid_for_image_generation_torch.models.generator import (
        Generator,
    )

    h = parallel_helpers()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_pm_dp_")
    try:
        witness = dp_reference(device, workdir, SEED, mode=PM_GLOO_MODE)
        torch.cuda.empty_cache()
        spawn_ranks(pm_rank, workdir)
        ranks = []
        for r in range(DP_WORLD):
            with open(os.path.join(workdir, f"pm_rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    config = PyramidGANConfig(compute_dtype="float32",
                              **h.PERF_MODES[PM_GLOO_MODE][0])
    with torch.device("meta"):
        nets = types.SimpleNamespace(generator=Generator(config),
                                     discriminator=Discriminator(config))
    per_step = h.step_collective_bytes(nets, DP_FP32_BATCH // DP_WORLD,
                                       DP_WORLD)
    want_bytes = {k: DP_FP32_STEPS * v for k, v in per_step.items()}
    want_launches = {k: DP_FP32_STEPS * v for k, v in h.float32_launches(
        h.PERF_MODE_LAUNCHES[PM_GLOO_MODE]).items()}
    limits = {k: max(floor, DP_WITNESS_FACTOR * witness[k])
              for k, floor in DP_LIMITS.items()}
    readings = ranks[0]["readings"]
    print(f"  (f) {card}: {PM_GLOO_MODE}, fp32, {DP_WORLD} ranks x "
          f"{DP_FP32_BATCH // DP_WORLD} rows vs one process on the "
          f"{DP_FP32_BATCH}, {DP_FP32_STEPS} steps: {readings}; witness "
          f"{witness}; limits {limits}; ranks' digests "
          f"{[r['digest'][:12] for r in ranks]}; bytes per rank over the "
          f"steps {[r['bytes'] for r in ranks]} (worked out: {want_bytes}); "
          f"launches per rank {[r['launches'] for r in ranks]}", flush=True)
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError("(f) the ranks' states differ")
    if broken(readings, limits):
        raise AssertionError(f"(f) the ranks break {broken(readings, limits)}")
    for r in ranks:
        if r["bytes"] != want_bytes or r["launches"] != want_launches:
            raise AssertionError(f"(f) bytes {r['bytes']} or launches "
                                 f"{r['launches']} are not {want_bytes}, "
                                 f"{want_launches}")


# --------------------------------------------------------------- phase 12 --


FS = 2  # the fsdp axis: both ranks of a (1, 2) (data, fsdp) mesh
FS_BF16_STEPS = 6  # (a): 1 warm-up + 5 timed, global batches of 64
FS_CLI_BATCH = BATCH  # (c): global batch 16, 8 rows per rank
# (b)'s runs: the sound one on each seed of DP_SEEDS, and on the first
# tests/torch_parallel_rank.py's FSDP faults (FSDP's default mean, the
# `inputs=` G backward, the whole leaves' gradients unsummed, Adam built
# before sharding): every run moves ~2.6 GB a step through gloo
FS_FAULTS = ("fsdp_grads_averaged", "inputs_backward", "whole_grads_local",
             "adam_before_sharding")


def fs_runs(seed: int) -> tuple:
    return ("sound", *FS_FAULTS) if seed == DP_SEEDS[0] else ("sound",)


def meta_nets(config):
    """G, D and the frozen VGG of `config` on the `meta` device."""
    import types

    from semantic_pyramid_for_image_generation_torch.models.discriminator import (  # noqa: E501
        Discriminator,
    )
    from semantic_pyramid_for_image_generation_torch.models.generator import (
        Generator,
    )
    from semantic_pyramid_for_image_generation_torch.models.vgg16 import VGG16

    with torch.device("meta"):
        nets = types.SimpleNamespace(generator=Generator(config),
                                     discriminator=Discriminator(config),
                                     vgg=VGG16(config))
    nets.vgg.requires_grad_(False)
    return nets


def fs_bf16_steps(device, device_mesh) -> dict:
    """(a) on one rank: phase 10's full-width bf16 state, broadcast, then
    sharded; FS_BF16_STEPS steps of this rank's 32 rows of global batches
    of 64. The rank's bytes of parameters and moments, memory allocated
    after sharding and the peak; per step ms, launches and bytes."""
    from semantic_pyramid_for_image_generation_torch.data.synthetic import (
        synthetic_batch,
    )
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
    from semantic_pyramid_for_image_generation_torch.parallel import mesh
    from semantic_pyramid_for_image_generation_torch.train.state import (
        state_bytes,
    )
    from semantic_pyramid_for_image_generation_torch.train.step import (
        batch_to_device,
        make_train_step,
    )

    rows_of = parallel_helpers().rows_of
    state = trainer_state(device)
    mesh.broadcast_state(state)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    mesh.shard_state(state, device_mesh)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    sharded = state_bytes(state)
    rows = mesh.shard_slice(DP_BF16_BATCH, DP_WORLD, mesh.rank())
    rng = np.random.default_rng(SEED)
    batches = [batch_to_device(rows_of(synthetic_batch(
        state.generator.config, DP_BF16_BATCH, rng), rows), device)
        for _ in range(FS_BF16_STEPS)]
    step = make_train_step()
    latents = torch.Generator(device).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    steps = []
    for batch in batches:
        launched, sent = kernels.launch_counts(), dict(mesh.collective_bytes)
        t0 = time.perf_counter()
        _, metrics = step(state, batch, latents)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = kernels.launch_counts()
        delta = {k: after[k] - launched[k] for k in after}
        if delta != TRAIN_LAUNCHES:
            raise AssertionError(f"rank {mesh.rank()} step launches {delta}")
        values = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in values.values()):
            raise AssertionError(f"non-finite losses {values}")
        steps.append({"ms": ms, "metrics": values,
                      "bytes": {k: mesh.collective_bytes[k] - sent[k]
                                for k in sent}})
    return {"steps": steps, "launches": kernels.launch_counts(),
            "digest": mesh.state_digest(state), "bytes_sharded": sharded,
            "bytes_after": state_bytes(state),
            "allocated_before": before, "allocated_after": allocated,
            "peak": torch.cuda.max_memory_allocated()}


def fs_fp32_runs(device, device_mesh, workdir: str) -> dict:
    """(b) on one rank, for each seed of DP_SEEDS: each run of `fs_runs`
    from the seed's initial state (dp_reference's file), sharded inside its
    planted fault, 2 fp32 steps of this rank's 8 rows; the sound run's
    digest, and on rank 0 each run's readings against the seed's
    reference."""
    import os

    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.parallel import mesh
    from semantic_pyramid_for_image_generation_torch.train.state import (
        init_train_state,
    )
    from semantic_pyramid_for_image_generation_torch.train.step import (
        batch_to_device,
        make_train_step,
    )

    h = parallel_helpers()
    rows = mesh.shard_slice(DP_FP32_BATCH, DP_WORLD, mesh.rank())
    step = make_train_step()
    out = {}
    for seed in DP_SEEDS:
        inputs = torch.load(os.path.join(workdir, f"default_inputs{seed}.pt"),
                            weights_only=False)
        ref = torch.load(os.path.join(workdir, f"default_reference{seed}.pt"),
                         weights_only=False) if mesh.rank() == 0 else None
        batches = [batch_to_device(h.rows_of(b, rows), device)
                   for b in inputs["batches"]]
        out[seed] = {}
        for run in fs_runs(seed):
            state = init_train_state(PyramidGANConfig(compute_dtype="float32"),
                                     device, lr=LR)
            for net in ("generator", "discriminator", "vgg"):
                getattr(state, net).load_state_dict(inputs[net])
            mesh.broadcast_state(state)
            got = {"metrics": []}
            with h.planted(run):
                mesh.shard_state(state, device_mesh)
                for batch in batches:
                    _, m = step(state, batch)
                    got["metrics"].append({k: float(v) for k, v in m.items()})
                    got.setdefault("grads", h.gradients(state))
            out[seed][run] = {"digest": mesh.state_digest(state)
                              if run == "sound" else None}
            for net in ("generator", "discriminator"):
                got[net] = h.to_cpu(getattr(state, net).state_dict())
            if ref is not None:
                out[seed][run]["readings"] = h.readings_against(got, ref, LR)
            del state
            torch.cuda.empty_cache()
    return out


def fs_rank(rank: int, workdir: str, port: int) -> None:
    """One gloo rank of phase 12 (a) and (b) on cuda:0 (spawned); its
    results to `<workdir>/fs_rank<r>.json`."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_WORLD),
                      LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    from semantic_pyramid_for_image_generation_torch.parallel import mesh

    device = mesh.init_distributed("cuda", backend="gloo")
    device_mesh = mesh.make_mesh(FS, "cuda")
    out = {"bf16": fs_bf16_steps(device, device_mesh)}
    torch.cuda.empty_cache()
    out["fp32"] = fs_fp32_runs(device, device_mesh, workdir)
    with open(os.path.join(workdir, f"fs_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    mesh.shutdown_distributed()


def drive_fsdp_ranks(device, card: str, phase10_ms: list) -> dict:
    """(a) and (b): the fp32 references in this process (phase 10's), then
    two spawned gloo ranks at --fsdp 2 on cuda:0."""
    import os
    import shutil
    import tempfile

    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.train.state import (
        sharded_state_bytes,
    )

    h = parallel_helpers()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_fsdp_")
    try:
        witness = {seed: dp_reference(device, workdir, seed)
                   for seed in DP_SEEDS}
        torch.cuda.empty_cache()
        spawn_ranks(fs_rank, workdir)
        ranks = []
        for r in range(DP_WORLD):
            with open(os.path.join(workdir, f"fs_rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    config = PyramidGANConfig(compute_dtype="bfloat16")
    nets = meta_nets(config)
    whole, halves = sharded_state_bytes(nets, 1), sharded_state_bytes(nets, FS)
    per_step = h.step_collective_bytes(nets, DP_BF16_BATCH // DP_WORLD,
                                       DP_WORLD, fsdp=FS)
    bf16 = [r["bf16"] for r in ranks]
    if len({r["digest"] for r in bf16}) != 1:
        raise AssertionError("(a) the ranks' states differ after the steps")
    for r, run in enumerate(bf16):
        timed = [s["ms"] for s in run["steps"][1:]]
        print(f"  (a) {card}: rank {r} at --fsdp {FS}, bf16, "
              f"{DP_BF16_BATCH // DP_WORLD} of {DP_BF16_BATCH} rows: "
              f"{statistics.median(timed):.2f} ms/step median of "
              f"{len(timed)} (spread {min(timed):.2f}-{max(timed):.2f}; "
              f"first {run['steps'][0]['ms']:.1f}; phase 10's --fsdp 1 "
              f"ranks {[round(t, 2) for t in phase10_ms]}); parameters + "
              f"Adam moments read {run['bytes_after']} (after sharding, "
              f"before a step: {run['bytes_sharded']}), worked out "
              f"{halves}, unsharded {whole} = "
              f"{sum(whole.values()) / 1e9:.3f} GB; allocated "
              f"{run['allocated_before'] / 2 ** 30:.3f} GiB before "
              f"sharding, {run['allocated_after'] / 2 ** 30:.3f} GiB "
              f"after, peak over the steps {run['peak'] / 2 ** 30:.2f} "
              f"GiB; collective bytes per step {run['steps'][-1]['bytes']} "
              f"(worked out {per_step}); launches per step "
              f"{TRAIN_LAUNCHES} (all {FS_BF16_STEPS} steps exact)",
              flush=True)
        if run["bytes_after"] != halves:
            raise AssertionError(f"(a) rank {r} holds {run['bytes_after']}, "
                                 f"worked out {halves}")
        for s in run["steps"]:
            if s["bytes"] != per_step:
                raise AssertionError(f"(a) rank {r} step bytes {s['bytes']}"
                                     f", worked out {per_step}")
    print(f"  (a) G, D, Adam moments, u/v and running statistics bitwise "
          f"equal on both ranks (sha256 of the gathered state "
          f"{bf16[0]['digest'][:16]}); last losses "
          f"{bf16[0]['steps'][-1]['metrics']}. Two ranks sharing one card "
          f"over gloo: the arithmetic and the bytes, not a multi-card speed",
          flush=True)
    failures = []
    for seed in DP_SEEDS:
        w = witness[seed]
        limits = {k: max(floor, DP_WITNESS_FACTOR * w[k])
                  for k, floor in DP_LIMITS.items()}
        runs = [r["fp32"][str(seed)] for r in ranks]
        print(f"  (b) {card}: seed {seed}, fp32, --fsdp {FS}, {DP_WORLD} "
              f"ranks x {DP_FP32_BATCH // DP_WORLD} rows vs one process on "
              f"the {DP_FP32_BATCH}, {DP_FP32_STEPS} steps; witness "
              f"{fmt(w)}; limits {fmt(limits)}", flush=True)
        for run in fs_runs(seed):
            readings = runs[0][run]["readings"]
            over = broken(readings, limits)
            print(f"    {run}: {fmt(readings)}; over {over}", flush=True)
            if run == "sound" and (over or runs[0][run]["digest"]
                                   != runs[1][run]["digest"]):
                failures.append(f"(b) seed {seed}: the sound ranks break "
                                f"{over} or differ")
            if run != "sound" and not over:
                failures.append(f"(b) seed {seed}: the hold missed {run}")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": bf16[0]["launches"]}


def fs_cli_rank(rank: int, workdir: str, port: int) -> None:
    """One gloo rank of (c) on cuda:0 (spawned): cli/main.py with the argv
    in `<workdir>/argv.json`, its output and launch counts to
    `<workdir>/cli_rank<r>.*`. The CLI joins nccl on the card; two ranks on
    one card need gloo, so the rank's `init_distributed` asks for it."""
    import contextlib
    import os
    import warnings

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_WORLD),
                      LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    from semantic_pyramid_for_image_generation_torch.cli import main as cli
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
    from semantic_pyramid_for_image_generation_torch.parallel import mesh

    join_group = mesh.init_distributed
    mesh.init_distributed = lambda device_type: join_group(device_type,
                                                           backend="gloo")
    with open(os.path.join(workdir, "argv.json")) as f:
        argv = json.load(f)
    kernels.reset_launch_counts()
    with open(os.path.join(workdir, f"cli_rank{rank}.txt"), "w") as log, \
            contextlib.redirect_stdout(log), contextlib.redirect_stderr(log), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.main(argv)
    with open(os.path.join(workdir, f"cli_rank{rank}.json"), "w") as f:
        json.dump(kernels.launch_counts(), f)


def drive_fsdp_cli(device, card: str) -> None:
    """(c) cli/main.py at full width in bf16 on a JPEG Places365 tree:
    `--multihost --fsdp 2 --train` on two gloo ranks, 2 steps of
    FS_CLI_BATCH (8 rows per rank), the validation at start of 2 x that,
    checkpoint_000.pt; one process restores it with --load_checkpoint and
    takes 2 more steps; the two ranks at --fsdp 2 restore that one-rank
    checkpoint and validate (`--test`). Each training run's backward
    launches are 2 steps' per rank."""
    import contextlib
    import glob
    import io
    import os
    import re
    import shutil
    import tempfile
    import warnings

    from semantic_pyramid_for_image_generation_torch.cli import main as cli
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels

    workdir = tempfile.mkdtemp(prefix="chip_smoke_fsdp_cli_")
    try:
        root = os.path.join(workdir, "places")
        write_places_tree(root, 2 * FS_CLI_BATCH, 2 * FS_CLI_BATCH)
        common = ["--device", str(device), "--epochs", "1", "--batch_size",
                  str(FS_CLI_BATCH), "--path_to_places365", root,
                  "--fid_images", str(2 * FS_CLI_BATCH), "--num_workers",
                  "4", "--allow_random_fid", "--fid_device_stats",
                  "--validate_after_n_iterations", "1000000", "--log_every",
                  "1", "--load_pretrained_vgg16", ""]
        sharded = ["--multihost", "--fsdp", str(FS)]
        summary = []

        def ranks(argv, label):
            with open(os.path.join(workdir, "argv.json"), "w") as f:
                json.dump(argv, f)
            t0 = time.perf_counter()
            try:
                spawn_ranks(fs_cli_rank, workdir)
            except BaseException:
                for r in range(DP_WORLD):
                    path = os.path.join(workdir, f"cli_rank{r}.txt")
                    if os.path.exists(path):
                        print(open(path).read()[-3000:], flush=True)
                raise
            outs, counts = [], []
            for r in range(DP_WORLD):
                with open(os.path.join(workdir, f"cli_rank{r}.txt")) as f:
                    outs.append(f.read())
                with open(os.path.join(workdir, f"cli_rank{r}.json")) as f:
                    counts.append(json.load(f))
            summary.append(f"{label}: {time.perf_counter() - t0:.1f} s, "
                           f"launches per rank {counts}")
            return outs, counts

        outs, counts = ranks(common + sharded + [
            "--train", "--save_data_path", os.path.join(workdir, "a")], "a")
        (first,) = glob.glob(os.path.join(workdir, "a", "models_*",
                                          "checkpoint_000.pt"))
        for c in counts:
            for name in ("max_pool_2x2_backward", "upsample_2x_backward",
                         "batch_norm_backward_sums", "batch_norm_backward_dx"):
                if c[name] != 2 * TRAIN_LAUNCHES[name]:
                    raise AssertionError(f"(c) a rank launched {name} "
                                         f"{c[name]} times")
        printed = io.StringIO()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed), \
                contextlib.redirect_stderr(printed), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cli.main(common + ["--train", "--load_checkpoint", first,
                               "--save_data_path",
                               os.path.join(workdir, "b")])
        if f"Restored checkpoint {first} (step 2)" not in printed.getvalue():
            print(printed.getvalue()[-3000:], flush=True)
            raise AssertionError("(c) one process did not restore the "
                                 "--fsdp 2 checkpoint")
        summary.append(f"b (one process): {time.perf_counter() - t0:.1f} "
                       f"s, launches {kernels.launch_counts()}")
        (second,) = glob.glob(os.path.join(workdir, "b", "models_*",
                                           "checkpoint_000.pt"))
        outs, _ = ranks(common + sharded + [
            "--test", "--load_checkpoint", second, "--save_data_path",
            os.path.join(workdir, "c")], "c")
        fids = [re.search(r"FID= (\S+)", out) for out in outs]
        restored = all(f"Restored checkpoint {second} (step 4)" in out
                       for out in outs)
        if not (restored and all(fids) and fids[0].group(1)
                == fids[1].group(1)):
            print(outs[0][-3000:], flush=True)
            raise AssertionError("(c) the --fsdp 2 ranks did not restore "
                                 "the one-rank checkpoint and agree")
        saved = torch.load(first, map_location="cpu", weights_only=False)
        print(f"  (c) {card}: the CLI at full width, bf16, global batch "
              f"{FS_CLI_BATCH}: (a) --multihost --fsdp {FS} --train on two "
              f"gloo ranks, 2 steps, validation at start, "
              f"{os.path.basename(first)} (step {saved['step']}, "
              f"{os.path.getsize(first) / 1e6:.1f} MB, whole tensors); (b) "
              f"one process restores it and takes 2 steps; (c) the --fsdp "
              f"{FS} ranks restore (b)'s file (step 4) and validate: FID "
              f"{fids[0].group(1)} on both; " + "; ".join(summary),
              flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 13 --


PG_TIMED = 8  # (c): timed requests per reader, after one warm-up each
PG_REQUESTS = {  # (c) and (b): (level, num_samples, class_id); None = auto
    "bucket 1": (0, 1, None),
    "bucket 1 class 42": (0, 1, 42),
    "bucket 16": (3, BATCH, 42),
}
PG_BAND = (0.05, 0.005)  # bf16 max and mean |difference| (test_bf16_rewrites)
PG_FP32_ATOL = 5e-6
PG_TIMEOUT_S = 300


def pg_artifacts(workdir: str) -> dict:
    """{(dtype, weights): artifact directory} of phase 13."""
    import os

    return {(dtype, weights): os.path.join(workdir, f"{dtype}_{weights}")
            for dtype in ("bfloat16", "float32")
            for weights in ("external", "baked")}


def pg_request(service, name: str, seed: int = 1) -> dict:
    level, n, class_id = PG_REQUESTS[name]
    return service.generate_arrays(request_image(), level=level,
                                   class_id=class_id, num_samples=n,
                                   seed=seed)


def pg_requests(weights: str) -> list:
    """The requests each artifact serves; a baked one has no classifier.
    The class-given bucket-1 request runs on both, so the two differ only
    in the weight inputs."""
    return (["bucket 1 class 42"] if weights == "baked" else list(PG_REQUESTS))


def program_child(workdir: str, device_type: str) -> None:
    """(b) In a fresh process (spawned; it imports what chip_smoke.py's top
    does, then the reader): load each artifact with ProgramArtifact, serve
    its requests once, and write the load seconds, launches, outputs and
    the port modules this process imported to `workdir`."""
    import os

    from semantic_pyramid_for_image_generation_torch.ops import (
        cuda as kernels,
    )
    from semantic_pyramid_for_image_generation_torch.serving.program import (
        ProgramArtifact,
    )
    from semantic_pyramid_for_image_generation_torch.serving.server import (
        GenerateService,
    )

    device = torch.device(device_type)
    result, outputs = {"load_s": {}, "first_ms": {}, "launches": {}}, {}
    for (dtype, weights), path in pg_artifacts(workdir).items():
        key = f"{dtype} {weights}"
        t0 = time.perf_counter()
        service = GenerateService(ProgramArtifact(path, device))
        torch.cuda.synchronize()
        result["load_s"][key] = time.perf_counter() - t0
        for name in pg_requests(weights):
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            out = pg_request(service, name)
            result["first_ms"][f"{key} {name}"] = (
                time.perf_counter() - t0) * 1e3
            after = kernels.launch_counts()
            result["launches"][f"{key} {name}"] = {
                k: after[k] - before[k] for k in after}
            outputs[f"{key} {name}"] = out["fakes"]
            result[f"{key} {name} class"] = out["class_id"]
    port = "semantic_pyramid_for_image_generation_torch."
    result["model_modules"] = sorted(
        m for m in sys.modules if m.startswith(
            (port + "models", port + "train", port + "serving.export")))
    np.savez(os.path.join(workdir, "child_outputs.npz"), **outputs)
    with open(os.path.join(workdir, "child.json"), "w") as f:
        json.dump(result, f)


def run_program_child(workdir: str, device) -> dict:
    import os

    import torch.multiprocessing as mp

    proc = mp.get_context("spawn").Process(target=program_child,
                                           args=(workdir, device.type))
    proc.start()
    proc.join(PG_TIMEOUT_S)
    if proc.is_alive():
        proc.kill()
        proc.join()
        raise AssertionError(f"the program reader ran past {PG_TIMEOUT_S} s")
    if proc.exitcode != 0:
        raise AssertionError(f"the program reader exited {proc.exitcode}")
    with open(os.path.join(workdir, "child.json")) as f:
        result = json.load(f)
    with np.load(os.path.join(workdir, "child_outputs.npz")) as z:
        result["outputs"] = {k: z[k] for k in z.files}
    return result


def pg_compare(got: np.ndarray, want: np.ndarray, dtype: str) -> str:
    """Hold `got` against `want` (fp32 within PG_FP32_ATOL, bf16 within
    PG_BAND); raise past it; say what was read and whether it is bitwise."""
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    if dtype == "float32":
        ok = diff.max() <= PG_FP32_ATOL
        limit = f"<= {PG_FP32_ATOL:g}"
    else:
        ok = diff.max() <= PG_BAND[0] and diff.mean() <= PG_BAND[1]
        limit = f"<= {PG_BAND[0]:g} max / {PG_BAND[1]:g} mean"
    text = (f"max {diff.max():.3g} mean {diff.mean():.3g} ({limit}; "
            f"{'bitwise' if diff.max() == 0 else 'not bitwise'})")
    if not ok:
        raise AssertionError(f"program output off: {text}")
    return text


def drive_serving_programs(device, card: str) -> dict:
    """(a) Export phase 5's full-width bf16 and fp32 modules as `cuda`
    programs: external at buckets 1 and 16 with the classifier, baked at
    bucket 1. (b) A fresh process loads them and serves one request each,
    importing no model code. (c) In this process, the programs against the
    eager modules: launches per request equal, outputs held, PG_TIMED
    requests timed after a warm-up, readers in turns (eager, program,
    program, eager, ...); one warm bf16 program request per bucket
    profiled. Returns the launches of (c)'s program requests."""
    import os
    import shutil
    import tempfile

    from semantic_pyramid_for_image_generation_torch.ops import (
        cuda as kernels,
    )
    from semantic_pyramid_for_image_generation_torch.serving.export import (
        save_artifact,
    )
    from semantic_pyramid_for_image_generation_torch.serving.program import (
        ProgramArtifact,
    )
    from semantic_pyramid_for_image_generation_torch.serving.server import (
        GenerateService,
    )

    g16, v16, g32, v32 = build_full_width_models(device)
    nets = {"bfloat16": (g16, v16), "float32": (g32, v32)}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_programs_")
    try:
        paths = pg_artifacts(workdir)
        for (dtype, weights), path in paths.items():
            t0 = time.perf_counter()
            manifest = (save_artifact(*nets[dtype], path, (1, BATCH))
                        if weights == "external" else
                        save_artifact(*nets[dtype], path, (1,),
                                      weights="baked", classifier=False))
            sizes = {f: os.path.getsize(os.path.join(path, f))
                     for f in sorted(os.listdir(path))}
            print(f"  (a) {dtype} {weights}: exported in "
                  f"{time.perf_counter() - t0:.2f} s, platforms "
                  f"{manifest['platforms']}, torch "
                  f"{manifest['torch_version']}; bytes {sizes}", flush=True)
        child = run_program_child(workdir, device)
        if child["model_modules"]:
            raise AssertionError(f"the program reader imported "
                                 f"{child['model_modules']}")
        print(f"  (b) fresh process: load s "
              f"{ {k: round(t, 2) for k, t in child['load_s'].items()} }; "
              f"first request ms "
              f"{ {k: round(t, 1) for k, t in child['first_ms'].items()} }; "
              f"no model, train or export module imported", flush=True)
        programs = {key: GenerateService(ProgramArtifact(path, device))
                    for key, path in paths.items()}
        kernels.reset_launch_counts()  # the program path: one request each
        outputs, deltas = {}, {}
        for (dtype, weights), program in programs.items():
            for name in pg_requests(weights):
                key = f"{dtype} {weights} {name}"
                before = kernels.launch_counts()
                outputs[key] = pg_request(program, name)
                after = kernels.launch_counts()
                deltas[key] = {k: after[k] - before[k] for k in after}
        program_launches = kernels.launch_counts()
        for (dtype, weights), program in programs.items():
            eager = service_for(*nets[dtype])
            for name in pg_requests(weights):
                key = f"{dtype} {weights} {name}"
                before = kernels.launch_counts()
                want = pg_request(eager, name)
                after = kernels.launch_counts()
                eager_delta = {k: after[k] - before[k] for k in after}
                vgg_forwards = 1 + (PG_REQUESTS[name][2] is None)
                expected = dict(GENERATE_LAUNCHES,
                                max_pool_2x2=5 * vgg_forwards + 1)
                if not (deltas[key] == eager_delta == child["launches"][key]
                        == expected):
                    raise AssertionError(
                        f"{key}: launches eager {eager_delta}, program "
                        f"{deltas[key]}, fresh process "
                        f"{child['launches'][key]}, expected {expected}")
                got = outputs[key]
                if not (got["class_id"] == want["class_id"]
                        == child[f"{key} class"]):
                    raise AssertionError(f"{key}: the program classifies "
                                         "otherwise")
                times = {eager: [], program: []}
                for rep, service in enumerate([eager, program, program,
                                               eager] * (PG_TIMED // 2)):
                    t0 = time.perf_counter()
                    pg_request(service, name, seed=2 + rep)
                    times[service].append((time.perf_counter() - t0) * 1e3)
                ms = {label: (statistics.median(t), min(t), max(t))
                      for label, t in (("program", times[program]),
                                       ("eager", times[eager]))}
                print(f"  (c) {key}: launches {deltas[key]} (= eager's and "
                      f"the fresh process's); ms/request median (min-max) "
                      f"of {PG_TIMED}: program {ms['program'][0]:.2f} "
                      f"({ms['program'][1]:.2f}-{ms['program'][2]:.2f}), "
                      f"eager {ms['eager'][0]:.2f} ({ms['eager'][1]:.2f}-"
                      f"{ms['eager'][2]:.2f}); against eager "
                      f"{pg_compare(got['fakes'], want['fakes'], dtype)}; "
                      f"the fresh process's against this one's "
                      f"{pg_compare(child['outputs'][key], got['fakes'], dtype)}",
                      flush=True)
        program = programs["bfloat16", "external"]
        for name in ("bucket 1", "bucket 16"):
            profile_summary(f"program bfloat16 {name}",
                            lambda: pg_request(program, name))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return program_launches

# --------------------------------------------------------------- phase 14 --

EV_BATCH = 32  # (a): the selftest's --batch_size
EV_VAL = 64  # (a): validation JPEGs (two VGG eval batches, two self-FID halves)
EV_SELF_FID_IMAGES = EV_BATCH  # (a): per half
EV_FID_IMAGES = EV_VAL  # (a): one validation batch of 2 x EV_BATCH
EV_RELAXED = [  # tests/test_artifact_selftest.py's: random weights pass
    "--expect_top1_before", "50.0", "60.0",
    "--expect_top5_before", "50.0", "60.0",
    "--expect_top1_after", "50.0", "60.0",
    "--expect_top5_after", "50.0", "60.0",
    "--expect_self_fid_max", "1e9", "--expect_fid_band", "0.0", "1e9"]
RH_IMAGES = 1024  # (b): the rehearsal's --num
RH_BATCH = 64  # (b): its --batch
RH_STAGE = 16  # (b): its --stage
EV_TIMEOUT_S = 300  # the phase's process (~55 s on the H100)


def write_evaluation_standins(root: str, device) -> dict:
    """(a)'s artifacts: full-width VGG-16 .pt files (random init from SEED;
    the caffe stand-in with the tree's classes biased up), the random-init
    Inception's torchvision-named state dict, a Places365 tree."""
    import os

    from semantic_pyramid_for_image_generation_torch.models.inception import (
        make_inception,
    )

    start = time.perf_counter()
    vgg = {k: v.cpu() for k, v in
           finetune_model(device, "float32").state_dict().items()}
    paths = {"vgg": os.path.join(root, "vgg16.pt"),
             "vgg_caffe": os.path.join(root, "vgg16_caffe.pt"),
             "inception": os.path.join(root, "inception.pth"),
             "places": os.path.join(root, "places365_standard")}
    torch.save(vgg, paths["vgg"])
    # the caffe stand-in: the tree's two classes lead every image's logits,
    # so top-5 reads 100% when the labels reach the eval step. Not the FID
    # run's VGG: fc8 logits of 100 saturate G's fakes, and scipy's sqrtm of
    # the near-zero covariance product (a random-init Inception) stalled
    # for minutes (scipy 1.18, the H100 machine's host)
    vgg["vgg16.classifier.6.bias"][:2] += 100.0
    torch.save(vgg, paths["vgg_caffe"])
    del vgg
    inception = make_inception(device,
                               rng=torch.Generator(device).manual_seed(SEED))
    torch.save({k: v.cpu() for k, v in inception.state_dict().items()},
               paths["inception"])
    del inception
    write_places_tree(paths["places"], 4, EV_VAL)
    print(f"  stand-ins written in {time.perf_counter() - start:.1f} s "
          f"(VGG-16 {os.path.getsize(paths['vgg']):,} B, Inception "
          f"{os.path.getsize(paths['inception']):,} B, {EV_VAL} validation "
          "JPEGs)", flush=True)
    return paths


def drive_selftest(device, root: str) -> dict:
    """(a) The selftest's main() on the stand-ins, each evaluation timed and
    its launches read; returns the launches of the whole run."""
    import contextlib
    import io

    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
    from semantic_pyramid_for_image_generation_torch.scripts import (
        artifact_selftest as selftest,
    )

    paths = write_evaluation_standins(root, device)
    runs = []

    def timed(name, fn):
        def run(*args):
            before = kernels.launch_counts()
            start = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            runs.append((name, time.perf_counter() - start,
                         {k: after[k] - before[k] for k in after}))
            return out
        return run

    argv = ["--places", paths["places"], "--vgg_pt", paths["vgg_caffe"],
            "--vgg_finetuned_pt", paths["vgg"],
            "--inception_pt", paths["inception"],
            "--batch_size", str(EV_BATCH), "--num_workers", "8",
            "--fid_images", str(EV_FID_IMAGES),
            "--self_fid_images", str(EV_SELF_FID_IMAGES),
            "--device", device.type] + EV_RELAXED
    originals = {name: getattr(selftest, name) for name in
                 ("run_vgg_accuracy", "run_self_fid", "run_fid")}
    out = io.StringIO()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(contextlib.chdir(root))  # the Trainer's run dirs
        for name, fn in originals.items():
            stack.callback(setattr, selftest, name, fn)
            setattr(selftest, name, timed(name, fn))
        stack.enter_context(contextlib.redirect_stdout(out))
        rc = selftest.main(argv)
    counts = kernels.launch_counts()
    total_s = time.perf_counter() - start
    for line in out.getvalue().strip().splitlines():
        print(f"  | {line}", flush=True)
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0 or report["passed"] is not True or report["ready"] is not True:
        raise AssertionError(f"the selftest failed (rc {rc}): {report}")
    if set(report["results"]) != {
            "vgg_top1_before", "vgg_top5_before", "vgg_top1_after",
            "vgg_top5_after", "self_fid", "fid"} or \
            report["results"]["vgg_top5_before"] != 100.0:
        raise AssertionError(f"selftest results {report['results']}")
    vgg_batches = -(-EV_VAL // EV_BATCH)
    generates = -(-EV_FID_IMAGES // (2 * EV_BATCH))
    want = {"run_vgg_accuracy": {k: 5 * vgg_batches if k == "max_pool_2x2"
                                 else 0 for k in GENERATE_LAUNCHES},
            "run_self_fid": {k: 0 for k in GENERATE_LAUNCHES},
            "run_fid": {k: generates * n for k, n in
                        GENERATE_LAUNCHES.items()}}
    for name, seconds, delta in runs:
        print(f"  {name}: {seconds:.2f} s, launches {delta} (expected "
              f"{want[name]})", flush=True)
        if delta != want[name]:
            raise AssertionError(f"{name} launched {delta}, expected "
                                 f"{want[name]}")
    if [name for name, *_ in runs] != ["run_vgg_accuracy", "run_vgg_accuracy",
                                       "run_self_fid", "run_fid"]:
        raise AssertionError(f"the selftest ran {runs}")
    print(f"  selftest main(): {total_s:.2f} s, passed", flush=True)
    return counts


def drive_rehearsal(device) -> dict:
    """(b) The FID rehearsal's parts at RH_IMAGES images, bf16: the moments
    pass and the device statistics; returns the pass's launches."""
    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
    from semantic_pyramid_for_image_generation_torch.scripts import (
        fid_rehearsal as rehearsal,
    )

    start = time.perf_counter()
    config = PyramidGANConfig(compute_dtype="bfloat16")
    generate_fn, evaluator = rehearsal.build(config, device)
    n_batches = -(-RH_IMAGES // RH_BATCH)
    staged = rehearsal.stage_batches(config, RH_BATCH,
                                     min(n_batches, RH_STAGE), device,
                                     np.random.default_rng(0))
    rehearsal.moments_pass(generate_fn, evaluator, staged, 1,
                           rehearsal.latent_stream(config, RH_BATCH, device))
    torch.cuda.synchronize()
    print(f"  rehearsal setup and first batch "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    n, totals = rehearsal.moments_pass(
        generate_fn, evaluator, staged, n_batches,
        rehearsal.latent_stream(config, RH_BATCH, device))
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = kernels.launch_counts()
    fid, device_s = rehearsal.device_statistics(n, totals)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: n_batches * v for k, v in GENERATE_LAUNCHES.items()}
    print(f"  rehearsal: {n} images at batch {RH_BATCH} (bf16) in {wall:.3f} "
          f"s, {2 * n / wall:.1f} images/s (real + fake); device statistics "
          f"{device_s:.4f} s (FID {fid:.6g}, random-init Inception); peak "
          f"{peak:.2f} GiB; launches {counts} (expected {want})", flush=True)
    if n != n_batches * RH_BATCH or not np.isfinite(fid):
        raise AssertionError(f"rehearsal: {n} images, FID {fid}")
    if counts != want:
        raise AssertionError(f"the rehearsal launched {counts}, expected "
                             f"{want}")
    return counts


def evaluation_child(workdir: str, device_type: str) -> None:
    """Phase 14 in a fresh process (spawned), as a user runs the scripts:
    (a) in `workdir`, then (b); the launches of each go to
    `workdir/child.json`. Past EV_TIMEOUT_S - 30 s it dumps every thread's
    stack to stderr, so a stall shows where it stands."""
    import faulthandler
    import os

    faulthandler.dump_traceback_later(EV_TIMEOUT_S - 30)
    device = torch.device(device_type)
    counts = {"selftest": drive_selftest(device, workdir)}
    torch.cuda.empty_cache()
    counts["rehearsal"] = drive_rehearsal(device)
    with open(os.path.join(workdir, "child.json"), "w") as f:
        json.dump(counts, f)
    faulthandler.cancel_dump_traceback_later()


def drive_evaluation_entry_points(device) -> dict:
    """Phase 14: (a) and (b) in a spawned process, joined within
    EV_TIMEOUT_S (killed and failed past it); the launches of each. The
    host's load average and this process's threads are printed first: the
    host statistics are a CPU sqrtm, slowed by whatever else runs."""
    import os
    import tempfile
    import threading

    import torch.multiprocessing as mp

    print(f"  host load average {os.getloadavg()}, {os.cpu_count()} CPUs; "
          f"{threading.active_count()} threads in this process", flush=True)
    with tempfile.TemporaryDirectory() as root:
        proc = mp.get_context("spawn").Process(target=evaluation_child,
                                               args=(root, device.type))
        proc.start()
        proc.join(EV_TIMEOUT_S)
        if proc.is_alive():
            proc.kill()
            proc.join()
            raise AssertionError(f"phase 14 ran past {EV_TIMEOUT_S} s")
        if proc.exitcode != 0:
            raise AssertionError(f"phase 14's process exited {proc.exitcode}")
        with open(os.path.join(root, "child.json")) as f:
            return json.load(f)


# --------------------------------------------------------------- phase 15 --

LR_BATCH = 64  # (a): the long run's --batch
LR_PER_CLASS = 64  # (a): training JPEGs per class, 2 epochs of 2 steps
LR_ARGV = ["--classes", "2", "--batch", str(LR_BATCH), "--steps", "4",
           "--validate_every_steps", "1000000"]  # (a): no mid-run validation
LR_VALIDATION_ROWS = 2 * 16  # (a): 2 classes x 16 validation JPEGs, one batch
LR_FULL_VALIDATION_ROWS = 2 * LR_BATCH  # the full-default run's val batch
CF_TOLERANCE = 1e-6  # (b): the /255 cancels in the min-max
LB_ARGV = ["--workers", "1,8", "--images", "128"]  # (c)
TR_TIMEOUT_S = 300  # the phase's process


def long_run_generates(args, epochs: int) -> int:
    """Generates of a long run, from Trainer.train: the start-of-run grid
    and validation, each mid-run validation and its grid, one grid per
    epoch; a validation is one generate per validation batch (2 x batch
    rows) of its FID images."""
    from semantic_pyramid_for_image_generation_torch.scripts import long_run

    fid_images = args.classes * long_run.VAL_PER_CLASS
    per_validation = -(-fid_images // (2 * args.batch))
    validations = args.steps // args.validate_every_steps
    return (1 + per_validation) * (1 + validations) + epochs


def drive_long_run(device, root: str) -> dict:
    """(a) scripts/long_run.py's run() at full width, bf16, per_class
    LR_PER_CLASS, LR_ARGV: its output prefixed `  | `, the summary checked
    (finite, its steps, its files, 2 checkpoints), launches exactly the
    steps' and the generates'. Returns the launches."""
    import contextlib
    import glob
    import io
    import os

    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
    from semantic_pyramid_for_image_generation_torch.scripts import long_run

    args = long_run.build_parser().parse_args(LR_ARGV + [
        "--data_dir", os.path.join(root, "data"),
        "--save_dir", os.path.join(root, "sd"),
        "--out", os.path.join(root, "out"), "--device", device.type])
    epochs = long_run.epochs_for(args.steps, args.classes, args.batch,
                                 LR_PER_CLASS)
    out = io.StringIO()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
        summary = long_run.run(args, per_class=LR_PER_CLASS)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    seconds = time.perf_counter() - start
    for line in out.getvalue().strip().splitlines():
        print(f"  | {line}", flush=True)
    generates = long_run_generates(args, epochs)
    want = {k: args.steps * TRAIN_LAUNCHES[k] + generates * n
            for k, n in GENERATE_LAUNCHES.items()}
    print(f"  (a) long run, {args.steps} steps of {args.batch} in {epochs} "
          f"epochs, {generates} generates: {seconds:.1f} s with the tree, "
          f"{summary['img_per_sec_end_to_end']} images/s end to end; "
          f"launches {counts} (expected {want})", flush=True)
    checkpoints = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(args.save_dir, "models_*", "checkpoint_*.pt")))
    files = [os.path.join(args.out, name) for name in
             summary["grids_kept"] + ["loss_curves.png", "summary.json"]]
    if summary["all_finite"] is not True or summary["steps"] != args.steps \
            or summary["samples"] != args.steps * args.batch \
            or len(summary["grids_kept"]) != 3 \
            or not all(os.path.getsize(f) > 0 for f in files) \
            or len(checkpoints) != epochs:
        raise AssertionError(f"long run: summary {summary}, checkpoints "
                             f"{checkpoints}")
    if counts != want:
        raise AssertionError(f"the long run launched {counts}, expected "
                             f"{want}")
    return counts


def check_compact_feed(device, root: str) -> None:
    """(b) One JPEG batch of (a)'s tree through Places365Loader, compact and
    float: the uint8 batch copied to the card as uint8 and normalized there
    (train/step.py::ensure_m11_images, float32) against the float32 batch
    copied up; the masks and labels equal."""
    import os

    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.data.places365 import (
        Places365,
        Places365Loader,
    )
    from semantic_pyramid_for_image_generation_torch.train.step import (
        batch_to_device,
        ensure_m11_images,
    )

    data = os.path.join(root, "data")
    config = PyramidGANConfig(compute_dtype="bfloat16")

    def first(compact: bool) -> dict:
        loader = Places365Loader(Places365(data, "train.txt", config),
                                 batch_size=LR_BATCH, num_workers=16,
                                 compact_feed=compact)
        return batch_to_device(next(iter(loader)), device)

    compact, full = first(True), first(False)
    images = compact["images"]
    if images.dtype != torch.uint8 or images.device.type != device.type:
        raise AssertionError(f"the compact batch reached the card as "
                             f"{images.dtype} on {images.device}")
    m11 = ensure_m11_images(images)
    if m11.dtype != torch.float32 or full["images"].dtype != torch.float32:
        raise AssertionError(f"ensure_m11_images gave {m11.dtype}")
    delta = (m11 - full["images"]).abs()
    masks = all(torch.equal(c.float(), f) for c, f in
                zip(compact["masks"], full["masks"]))
    labels = torch.equal(compact["labels"], full["labels"])
    print(f"  (b) compact feed against float feed, {tuple(images.shape)} "
          f"uint8 on the card: ensure_m11_images max |difference| "
          f"{delta.max().item():.3g} (mean {delta.mean().item():.3g}; "
          f"tolerance {CF_TOLERANCE:g}); masks equal {masks} "
          f"({compact['masks'][0].dtype} against {full['masks'][0].dtype}); "
          f"labels equal {labels}", flush=True)
    if delta.max().item() > CF_TOLERANCE or not masks or not labels:
        raise AssertionError("the compact feed disagrees with the float feed")


def drive_loader_bench(device) -> dict:
    """(c) scripts/loader_scaling_bench.py's run() with LB_ARGV at full
    width: its rows and summary prefixed `  | `, launches exactly the train
    steps' of the bench's defaults (bench.WARMUP + bench.STEPS). Returns
    the launches."""
    import contextlib
    import io

    from semantic_pyramid_for_image_generation_torch.config import (
        PyramidGANConfig,
    )
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
    from semantic_pyramid_for_image_generation_torch.scripts import (
        loader_scaling_bench as bench,
    )

    args = bench.build_parser().parse_args(LB_ARGV + ["--device",
                                                      device.type])
    out = io.StringIO()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rows, summary = bench.run(args, PyramidGANConfig())
    counts = kernels.launch_counts()
    for line in out.getvalue().strip().splitlines():
        print(f"  | {line}", flush=True)
    want = {k: (bench.WARMUP + bench.STEPS) * n
            for k, n in TRAIN_LAUNCHES.items()}
    rate = summary["device_rate_to_beat_img_per_s"]
    print(f"  (c) loader bench {time.perf_counter() - start:.1f} s: mask "
          f"route {summary['mask_route']}, the card's bf16 batch-{args.batch} "
          f"step rate {rate} images/s, loader at {rows[-1]['num_workers']} "
          f"workers {rows[-1]['loader_img_per_s']} images/s; launches "
          f"{counts} (expected {want})", flush=True)
    if not (np.isfinite(rate) and rate > 0) or len(rows) != 2:
        raise AssertionError(f"loader bench: {rows} {summary}")
    if counts != want:
        raise AssertionError(f"the loader bench launched {counts}, expected "
                             f"{want}")
    return counts


def training_child(workdir: str, device_type: str) -> None:
    """Phase 15 in a fresh process (spawned), as a user runs the scripts:
    (a), (b) and (c) in `workdir`; the launches of (a) and (c) go to
    `workdir/child.json`. Past TR_TIMEOUT_S - 30 s it dumps every thread's
    stack to stderr."""
    import faulthandler
    import os

    faulthandler.dump_traceback_later(TR_TIMEOUT_S - 30)
    device = torch.device(device_type)
    counts = {}
    counts["long_run"] = drive_long_run(device, workdir)
    check_compact_feed(device, workdir)
    torch.cuda.empty_cache()
    counts["loader_bench"] = drive_loader_bench(device)
    with open(os.path.join(workdir, "child.json"), "w") as f:
        json.dump(counts, f)
    faulthandler.cancel_dump_traceback_later()


def drive_training_entry_points(device) -> dict:
    """Phase 15: (a), (b) and (c) in a spawned process, joined within
    TR_TIMEOUT_S (killed and failed past it); the launches of (a) and
    (c)."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as root:
        proc = mp.get_context("spawn").Process(target=training_child,
                                               args=(root, device.type))
        proc.start()
        proc.join(TR_TIMEOUT_S)
        if proc.is_alive():
            proc.kill()
            proc.join()
            raise AssertionError(f"phase 15 ran past {TR_TIMEOUT_S} s")
        if proc.exitcode != 0:
            raise AssertionError(f"phase 15's process exited {proc.exitcode}")
        with open(os.path.join(root, "child.json")) as f:
            return json.load(f)


# --------------------------------------------------------------- phase 16 --

RE_ARGV = ["--batch_size", "16", "--steps", "2", "--warmup", "1"]  # (c)
RE_LANES = ("", "--per-step", "--trainer", "--host-pipeline", "--serving",
            "--serving-artifact", "--vgg-finetune", "--check-pallas")
RE_ENTRY_TOLERANCE = 1e-4  # (a): phase 4's fp32 end-to-end tolerance
RE_RANKS = 4  # (b): dryrun_multichip's ranks, sharing the card
RE_TIMEOUT_S = 300  # the phase's process
G_FORWARD_LAUNCHES = {  # per eval Generator forward: its attention and KV pool
    "pooled_kv_attention": 1, "upsample_2x": 11, "max_pool_2x2": 1,
    "max_pool_2x2_backward": 0, "upsample_2x_backward": 0, **NO_BATCH_NORMS}


def scaled(launches: dict, n: int) -> dict:
    return {k: n * v for k, v in launches.items()}


def added(*launches: dict) -> dict:
    return {k: sum(d[k] for d in launches) for k in launches[0]}


@contextlib.contextmanager
def plain_kernels():
    """The three forward kernels' custom ops swapped for their plain
    versions for the duration: a CUDA tensor then runs the plain PyTorch
    version and counts no launch."""
    from semantic_pyramid_for_image_generation_torch.ops.cuda import (
        attention,
        pool,
        resize,
    )

    swaps = [(attention, "_pooled_kv_attention_op",
              attention.pooled_kv_attention_plain),
             (pool, "_max_pool_2x2_op", pool.max_pool_2x2_plain),
             (resize, "_upsample_2x_op", resize.upsample_2x_plain)]
    kept = [getattr(module, name) for module, name, _ in swaps]
    try:
        for module, name, plain in swaps:
            setattr(module, name, plain)
        yield
    finally:
        for (module, name, _), op in zip(swaps, kept):
            setattr(module, name, op)


def drive_entry(device) -> dict:
    """(a) graft_entry.entry(): the full-width fp32 Generator's eval forward
    at batch 4 on the example arguments, launches exactly one Generator
    forward's; then, u/v advanced 10 power iterations (unsaturated output),
    on those and on random arguments, the same call with the plain kernels
    (no launch) within RE_ENTRY_TOLERANCE; the torch.export program of fn
    against fn. Returns the launches."""
    from semantic_pyramid_for_image_generation_torch import graft_entry
    from semantic_pyramid_for_image_generation_torch.models.layers import (
        advance_spectral_norm_,
    )
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
    from semantic_pyramid_for_image_generation_torch.utils.device import (
        exact_float32,
    )

    fn, args = graft_entry.entry(device)
    g = torch.Generator(device).manual_seed(SEED)
    latent, features, masks, labels = args
    random_args = (torch.randn(latent.shape, generator=g, device=device),
                   tuple(torch.randn(f.shape, generator=g, device=device)
                         for f in features),
                   tuple((torch.rand(m.shape, generator=g, device=device)
                          > 0.5).float() for m in masks),
                   labels)
    kernels.reset_launch_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    # from the random u/v of an init every pixel saturates the tanh; with
    # u/v advanced as phase 4 does, the comparison holds something
    with torch.no_grad():
        advance_spectral_norm_(fn.generator, 10)
    errors, saturated = {}, {}
    for name, call_args in (("example", args), ("random", random_args)):
        got = fn(*call_args)
        kernels.reset_launch_counts()
        with plain_kernels():
            want = fn(*call_args)
        if any(kernels.launch_counts().values()):
            raise AssertionError("plain_kernels() still launched a kernel")
        if not torch.isfinite(got).all():
            raise AssertionError(f"entry(): non-finite output on {name}")
        errors[name] = (got - want).abs().max().item()
        saturated[name] = (got.abs() > 0.999).float().mean().item()
    start = time.perf_counter()
    program = torch.export.export(fn, random_args, strict=False).module()
    export_s = time.perf_counter() - start
    with exact_float32():
        traced = program(*random_args)
    direct = fn(*random_args)
    program_err = (traced - direct).abs().max().item()
    print(f"  (a) entry(): {tuple(out.shape)} {out.dtype}, finite; launches "
          f"{counts} (expected {G_FORWARD_LAUNCHES}); u/v advanced 10 "
          f"iterations, kernels against plain max |difference| {errors} "
          f"(tolerance {RE_ENTRY_TOLERANCE:g}; saturated share {saturated}); "
          f"torch.export {export_s:.1f} s, program against fn "
          f"{program_err:.3g} (bitwise {torch.equal(traced, direct)})",
          flush=True)
    if tuple(out.shape) != (graft_entry.ENTRY_BATCH, 3, 256, 256) \
            or not torch.isfinite(out).all():
        raise AssertionError(f"entry(): output {tuple(out.shape)}")
    if counts != G_FORWARD_LAUNCHES:
        raise AssertionError(f"entry() launched {counts}")
    if max(errors.values()) > RE_ENTRY_TOLERANCE \
            or program_err > RE_ENTRY_TOLERANCE \
            or max(saturated.values()) > 0.01:
        raise AssertionError("entry() disagrees with its plain kernels or "
                             "its program")
    return counts


def drive_dryrun(device) -> dict:
    """(b) graft_entry.dryrun_multichip(RE_RANKS) on the card: its OK line,
    the (2, 2) mesh, the grid side; rank 0's launches exactly one train
    step's and 4 generates' (3 validation batches, the grid). Returns
    them."""
    from semantic_pyramid_for_image_generation_torch import graft_entry

    result = graft_entry.dryrun_multichip(RE_RANKS, device.type)
    want = added(FP32_TRAIN_LAUNCHES, scaled(GENERATE_LAUNCHES, 4))
    print(f"  (b) dryrun_multichip({RE_RANKS}): {result['seconds']:.1f} s, "
          f"mesh {result['mesh']}, grid {result['grid_side']}, FID (random "
          f"backbone) {result['fid']:.4g}; rank 0 launches "
          f"{result['launches']} (expected {want})", flush=True)
    if result["mesh"] != {"data": 2, "fsdp": 2} \
            or result["grid_side"] != 1808 or result["device"] != "cuda":
        raise AssertionError(f"dryrun_multichip: {result}")
    if result["launches"] != want:
        raise AssertionError(f"a dry-run rank launched {result['launches']}")
    return result["launches"]


def lane_launches(lane: str, args) -> dict:
    """A lane's launches at `args`, worked out from what it runs: train
    steps (TRAIN_LAUNCHES), generates, fine-tune steps, attention checks."""
    from semantic_pyramid_for_image_generation_torch import bench

    none = scaled(TRAIN_LAUNCHES, 0)
    if lane == "--trainer":
        per_class = bench.trainer_per_class(args.batch_size, args.steps)
        return scaled(TRAIN_LAUNCHES, 2 * (4 * per_class // args.batch_size))
    if lane in ("--serving", "--serving-artifact"):
        return scaled(GENERATE_LAUNCHES, 2 * args.steps)
    if lane == "--vgg-finetune":
        return scaled(FINETUNE_LAUNCHES, args.warmup + args.steps)
    if lane == "--check-pallas":  # the kernel forward once per dtype
        return dict(none, pooled_kv_attention=2)
    if lane == "":
        return scaled(TRAIN_LAUNCHES, 2 * args.steps)
    return scaled(TRAIN_LAUNCHES, args.warmup + args.steps)


def drive_bench_lanes(device) -> dict:
    """(c) Each lane of the port's bench at full width in bf16 with
    RE_ARGV: its output prefixed `  | `, its one JSON line (finite,
    positive), launches exactly `lane_launches`; --check-pallas must read
    PASS in fp32 and bf16. Returns {lane: launches}."""
    import contextlib
    import io

    from semantic_pyramid_for_image_generation_torch import bench
    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels

    results = {}
    for lane in RE_LANES:
        argv = RE_ARGV + (["--device", device.type] + ([lane] if lane else []))
        args = bench.build_parser().parse_args(argv)
        out = io.StringIO()
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = bench.main(argv)
        counts = kernels.launch_counts()
        seconds = time.perf_counter() - start
        for text in out.getvalue().strip().splitlines():
            print(f"  | {text}", flush=True)
        lines = [json.loads(t) for t in out.getvalue().splitlines()
                 if t.startswith("{")]
        want = lane_launches(lane, args)
        name = lane or "default"
        print(f"  (c) {name}: {seconds:.1f} s, launches {counts} (expected "
              f"{want})", flush=True)
        if rc != 0 or len(lines) != 1 or list(lines[0]) != [
                "metric", "value", "unit", "vs_baseline"]:
            raise AssertionError(f"lane {name}: rc {rc}, lines {lines}")
        value = lines[0]["value"]
        if lane == "--check-pallas":
            if ": PASS {" not in lines[0]["metric"] \
                    or lines[0]["metric"].count("'pass': True") != 2:
                raise AssertionError(f"--check-pallas: {lines[0]}")
        elif not (np.isfinite(value) and value > 0):
            raise AssertionError(f"lane {name}: value {value}")
        if counts != want:
            raise AssertionError(f"lane {name} launched {counts}, expected "
                                 f"{want}")
        results[name] = counts
    return results


def root_entry_points_child(workdir: str, device_type: str) -> None:
    """Phase 16 in a fresh process (spawned): (a), (b) and (c); the
    launches go to `workdir/child.json`. Past RE_TIMEOUT_S - 30 s it dumps
    every thread's stack to stderr."""
    import faulthandler
    import os

    faulthandler.dump_traceback_later(RE_TIMEOUT_S - 30)
    device = torch.device(device_type)
    counts = {"entry": drive_entry(device)}
    torch.cuda.empty_cache()
    counts["dryrun_rank"] = drive_dryrun(device)
    counts["bench"] = drive_bench_lanes(device)
    with open(os.path.join(workdir, "child.json"), "w") as f:
        json.dump(counts, f)
    faulthandler.cancel_dump_traceback_later()


def drive_root_entry_points(device) -> dict:
    """Phase 16: (a), (b) and (c) in a spawned process, joined within
    RE_TIMEOUT_S (killed and failed past it); their launches."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as root:
        proc = mp.get_context("spawn").Process(
            target=root_entry_points_child, args=(root, device.type))
        proc.start()
        proc.join(RE_TIMEOUT_S)
        if proc.is_alive():
            proc.kill()
            proc.join()
            raise AssertionError(f"phase 16 ran past {RE_TIMEOUT_S} s")
        if proc.exitcode != 0:
            raise AssertionError(f"phase 16's process exited {proc.exitcode}")
        with open(os.path.join(root, "child.json")) as f:
            return json.load(f)


# --------------------------------------------------------------- phase 17 --

PS_BATCH = 128  # (a): the JAX script's operating point
PS_ARGV = ["--batch", str(PS_BATCH), "--steps", "2", "--warmup", "1"]
PS_SHARE_SLACK = 0.5  # (a): the category shares, each rounded to 0.01
MB_ARGV = ["--batch", "128", "--iters", "3"]  # (b)
PF_TIMEOUT_S = 300  # the phase's process (~40 s on the H100)


def drive_profile_step(device) -> tuple:
    """(a) profile_step's capture and analyze in a temp dir; returns the
    report and the counters' launches over the capture."""
    import tempfile

    from semantic_pyramid_for_image_generation_torch.ops import cuda as kernels
    from semantic_pyramid_for_image_generation_torch.scripts import (
        profile_step as ps,
    )

    args = ps.build_parser().parse_args(PS_ARGV + ["--device", device.type])
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as log_dir:
        ps.capture(args, log_dir)
        captured = time.perf_counter()
        report = ps.analyze(log_dir, args.steps)
    counts = kernels.launch_counts()
    steps = args.warmup + 1 + ps.UNPROFILED_WINDOWS * args.steps + args.steps
    shares = report["category_shares_pct"]
    print(f"  (a) profile_step, bf16 batch {PS_BATCH}: capture "
          f"{captured - start:.1f} s, analyze "
          f"{time.perf_counter() - captured:.1f} s; device "
          f"{report['total_device_us_per_step']:.1f} us/step, wall "
          f"{report['wall_us_per_step']:.1f} us/step profiled and "
          f"{report['unprofiled_us_per_step']:.1f} unprofiled, busy "
          f"{report['device_busy_pct']}%; step_flops {report['step_flops']:,},"
          f" step_mfu_pct {report['step_mfu_pct']} (unprofiled "
          f"{report['step_mfu_pct_unprofiled']})", flush=True)
    print(f"    category shares (sum {sum(shares.values()):.2f}): {shares}",
          flush=True)
    for row in report["top_ops"]:
        print(f"    {row['self_us_per_step']:10.1f} us "
              f"{row['share_pct']:5.2f}% {row['category']:12s} "
              f"{row['bound_by'] or '-':10s} roofline "
              f"{row['roofline_pct']}% {row['gflops_per_s']} GFLOP/s "
              f"{row['mem_bw_gib_s']} GiB/s n={row['n']} {row['op']} "
              f"{json.dumps(row['shapes'])[:90]}", flush=True)
    for row in report["data_formatting_ops"][:6]:
        print(f"    formatting {row['self_us_per_step']:9.1f} us "
              f"{row['share_pct']:5.2f}% {row['op'][:60]} in {row['within']} "
              f"{json.dumps(row['shapes'])[:40]}", flush=True)
    for row in report["top_launchers"][:6]:
        print(f"    launched by {row['launched_by']} in {row['within']}: "
              f"{row['us_per_step']:.1f} us ({row['share_pct']}%)",
              flush=True)
    want = scaled(TRAIN_LAUNCHES, steps)
    print(f"    launches per step (trace) {report['launches_per_step']} "
          f"(expected {TRAIN_LAUNCHES}); counters over {steps} steps "
          f"{counts} (expected {want})", flush=True)
    if report["launches_per_step"] != TRAIN_LAUNCHES or counts != want:
        raise AssertionError("profile_step's launches differ")
    if abs(sum(shares.values()) - 100) > PS_SHARE_SLACK:
        raise AssertionError(f"the category shares sum to "
                             f"{sum(shares.values())}")
    for key in ("step_mfu_pct", "step_mfu_pct_unprofiled"):
        if not (report[key] is not None and 0 < report[key] <= 100):
            raise AssertionError(f"{key} {report[key]}")
    return report, counts


def drive_microbenchmarks(device) -> dict:
    """(b) The three microbenchmarks' main() with MB_ARGV; returns their
    JSON lines by name."""
    import contextlib
    import io

    from semantic_pyramid_for_image_generation_torch.scripts import (
        finalblock_bench,
        inputconv_bwd_bench,
        s2d_stem_bench,
    )

    lines = {}
    for module in (finalblock_bench, inputconv_bwd_bench, s2d_stem_bench):
        name = module.__name__.rsplit(".", 1)[-1]
        out = io.StringIO()
        torch.cuda.empty_cache()
        start = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = module.main(MB_ARGV + ["--device", device.type])
        for text in out.getvalue().strip().splitlines():
            print(f"  | {text}", flush=True)
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        print(f"  (b) {name}: {time.perf_counter() - start:.1f} s", flush=True)
        times = list(line["ms_per_iter"].values())
        if rc != 0 or not all(np.isfinite(t) and t > 0 for t in times):
            raise AssertionError(f"{name}: rc {rc}, {line['ms_per_iter']}")
        lines[name] = line
    checks = lines["finalblock_bench"]["float32_checks"]
    if max(checks["stats_mean_abs_err"], checks["stats_meansq_rel_err"]) \
            > finalblock_bench.STATS_TOLERANCE or max(
                v for k, v in checks.items() if k.startswith("folded")) \
            > finalblock_bench.CHAIN_TOLERANCE:
        raise AssertionError(f"finalblock's float32 checks: {checks}")
    one_each = dict(scaled(TRAIN_LAUNCHES, 0), upsample_2x=1,
                    upsample_2x_backward=1)
    for chain, counts in lines["finalblock_bench"][
            "launches_per_iter"].items():
        if counts != one_each:
            raise AssertionError(f"finalblock {chain} launched {counts}")
    tolerance = inputconv_bwd_bench.TOLERANCE
    for variant, errs in lines["inputconv_bwd_bench"][
            "float32_rel_err_vs_no_pad"].items():
        if any(errs[k] > tolerance[k] for k in tolerance):
            raise AssertionError(f"inputconv {variant}: {errs}")
    for variant, err in lines["s2d_stem_bench"][
            "float32_rel_err_vs_direct"].items():
        if err > s2d_stem_bench.TOLERANCE:
            raise AssertionError(f"s2d {variant}: {err}")
    return lines


def check_final_block_sites(device) -> dict:
    """(c) Kernels 3 and 5 at the final block's shape against their plain
    versions: timed at PS_BATCH in bf16 and fp32, held at the finalblock
    bench's check batch. Returns {kernel: {dtype: row}}."""
    from semantic_pyramid_for_image_generation_torch.scripts import (
        finalblock_bench,
    )

    specs = kernel_specs(device)
    c, hw = finalblock_bench.CHANNELS, finalblock_bench.SIZE
    rows = {}
    for name, scale in (("upsample_2x", 1), ("upsample_2x_backward", 2)):
        rows[name] = {}
        for dtype in DTYPES:
            site = measure_site(name, specs[name],
                                (PS_BATCH, c, scale * hw, scale * hw), dtype,
                                large=True)
            site["bound_by"] = ("bytes" if site.pop("bytes_ms")
                                >= site.pop("flops_ms") else "operations")
            rows[name][str(dtype)[6:]] = site
            hold_sites(specs, name, [((finalblock_bench.CHECK_BATCH, c,
                                       scale * hw, scale * hw), dtype)],
                       f"{str(dtype)[6:]} final block at the check batch")
    torch.cuda.empty_cache()
    return rows


def profiling_child(workdir: str, device_type: str) -> None:
    """Phase 17 in a fresh process (spawned): (a), (b) and (c); the
    launches and the final block's readings go to `workdir/child.json`.
    Past PF_TIMEOUT_S - 30 s it dumps every thread's stack to stderr."""
    import faulthandler
    import os

    faulthandler.dump_traceback_later(PF_TIMEOUT_S - 30)
    device = torch.device(device_type)
    report, counts = drive_profile_step(device)
    lines = drive_microbenchmarks(device)
    sites = check_final_block_sites(device)
    with open(os.path.join(workdir, "child.json"), "w") as f:
        json.dump({"counts": counts,
                   "launches_per_step": report["launches_per_step"],
                   "finalblock_launches_per_iter": lines[
                       "finalblock_bench"]["launches_per_iter"],
                   "sites": sites}, f)
    faulthandler.cancel_dump_traceback_later()


def drive_profiling_entry_points(device) -> dict:
    """Phase 17: (a), (b) and (c) in a spawned process, joined within
    PF_TIMEOUT_S (killed and failed past it). In this process, after the
    profiles of phase 9, a trace of the batch-128 step lost device events
    (57 of 60 max pool launches in one run); a fresh process records them
    all."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as root:
        proc = mp.get_context("spawn").Process(
            target=profiling_child, args=(root, device.type))
        proc.start()
        proc.join(PF_TIMEOUT_S)
        if proc.is_alive():
            proc.kill()
            proc.join()
            raise AssertionError(f"phase 17 ran past {PF_TIMEOUT_S} s")
        if proc.exitcode != 0:
            raise AssertionError(f"phase 17's process exited {proc.exitcode}")
        with open(os.path.join(root, "child.json")) as f:
            return json.load(f)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    smoke_start = time.perf_counter()
    device = torch.device("cuda")
    from semantic_pyramid_for_image_generation_torch.ops.cuda import build
    from semantic_pyramid_for_image_generation_torch.utils.device import (
        card_line,
    )

    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    start = time.perf_counter()
    build.library()
    print(f"[2] kernels built in {time.perf_counter() - start:.1f} s", flush=True)
    print_ptxas_lines(build.build_log())
    check_sass(build.build())

    print("[3] kernels against their plain versions (batch 16 timed; the "
          "generate and train batches checked)", flush=True)
    memory_ceilings(device)
    kernels = check_kernels(device)
    kernels.update(time_batch_norm_kernels(device))

    print("[4] tiny end-to-end references", flush=True)
    check_tiny_reference(device)
    check_tiny_train_step(device)

    print("[5] serving path: full-width requests, bf16 then fp32", flush=True)
    serving = drive_main_path(device)
    for name, count in serving.items():
        if (count == 0) != (GENERATE_LAUNCHES[name] == 0):
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
          "sites, the CLI, the modules reader", flush=True)
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

    print("[10] data parallel: two gloo ranks on the card (bf16 steps, the "
          "fp32 hold and its planted faults), then one rank over NCCL",
          flush=True)
    start = time.perf_counter()
    parallel = drive_gloo_ranks(device, card)
    for name, count in parallel["launches"].items():
        if count == 0:
            raise AssertionError(f"{name} was never launched on a rank")
        kernels[name]["parallel_rank_launches"] = count
    drive_nccl_trainer(device, card, trainer["validation"],
                       train_results["bfloat16"]["ms_per_step"])
    print(f"  phase 10 took {time.perf_counter() - start:.1f} s", flush=True)

    print("[11] perf modes: full-width bf16 steps per mode, the fp32 remat "
          "and fused-D holds, the CLI, two gloo ranks", flush=True)
    start = time.perf_counter()
    perf = drive_perf_modes(device, card)
    for name, count in perf["launches"].items():
        if count == 0:
            raise AssertionError(f"{name} was never launched in the perf "
                                 "modes")
        kernels[name]["perf_mode_launches"] = count
        kernels[name]["perf_mode_launches_per_step"] = {
            mode: delta[name] for mode, delta in perf["per_step"].items()}
    check_perf_mode_holds(device, card)
    drive_perf_mode_cli(device, card)
    drive_perf_mode_ranks(device, card)
    print(f"  phase 11 took {time.perf_counter() - start:.1f} s", flush=True)

    print("[12] sharded state (--fsdp 2): two gloo ranks on the card (bf16 "
          "steps, bytes, the fp32 hold and its planted faults), the CLI",
          flush=True)
    start = time.perf_counter()
    sharded = drive_fsdp_ranks(device, card, parallel["ms"])
    for name, count in sharded["launches"].items():
        if count == 0:
            raise AssertionError(f"{name} was never launched on a sharded "
                                 "rank")
        kernels[name]["fsdp_rank_launches"] = count
    drive_fsdp_cli(device, card)
    print(f"  phase 12 took {time.perf_counter() - start:.1f} s", flush=True)

    print("[13] serving programs: full-width bf16 and fp32 cuda programs "
          "exported, loaded in a fresh process, served against eager",
          flush=True)
    start = time.perf_counter()
    programs = drive_serving_programs(device, card)
    for name, count in programs.items():
        if (count == 0) != (GENERATE_LAUNCHES[name] == 0):
            raise AssertionError(f"the programs launched {name} {count} "
                                 "times")
        kernels[name]["program_launches"] = count
    print(f"  phase 13 took {time.perf_counter() - start:.1f} s", flush=True)

    print("[14] evaluation entry points: the artifact selftest at full width "
          "on stand-ins, the FID rehearsal's parts", flush=True)
    start = time.perf_counter()
    evaluation = drive_evaluation_entry_points(device)
    for path, counts in evaluation.items():
        for name, count in counts.items():
            kernels[name][f"{path}_launches"] = count
    print(f"  phase 14 took {time.perf_counter() - start:.1f} s", flush=True)

    print("[15] training entry points: a short long run at full width fed "
          "from JPEGs, the compact feed against the float feed, the loader "
          "scaling bench", flush=True)
    start = time.perf_counter()
    training = drive_training_entry_points(device)
    for path, counts in training.items():
        for name, count in counts.items():
            kernels[name][f"{path}_launches"] = count
    print(f"  phase 15 took {time.perf_counter() - start:.1f} s", flush=True)

    print("[16] root entry points: graft_entry's entry() and "
          f"dryrun_multichip({RE_RANKS}) on the card, the bench's eight lanes "
          "at full width", flush=True)
    start = time.perf_counter()
    roots = drive_root_entry_points(device)
    for name in kernels:
        kernels[name]["entry_launches"] = roots["entry"][name]
        kernels[name]["dryrun_rank_launches"] = roots["dryrun_rank"][name]
        kernels[name]["bench_launches"] = sum(
            counts[name] for counts in roots["bench"].values())
        kernels[name]["bench_launches_per_lane"] = {
            lane: counts[name] for lane, counts in roots["bench"].items()}
    print(f"  phase 16 took {time.perf_counter() - start:.1f} s", flush=True)

    print("[17] profiling entry points: profile_step at full width, bf16 "
          f"batch {PS_BATCH}; the three microbenchmarks; Kernels 3 and 5 at "
          "the final block's shape", flush=True)
    start = time.perf_counter()
    profiling = drive_profiling_entry_points(device)
    for name in kernels:
        kernels[name]["profile_step_launches"] = profiling["counts"][name]
        kernels[name]["profile_step_launches_per_step"] = \
            profiling["launches_per_step"][name]
    for name, rows in profiling["sites"].items():
        kernels[name]["finalblock"] = rows
        kernels[name]["finalblock_launches_per_iter"] = {
            chain: counts[name] for chain, counts in profiling[
                "finalblock_launches_per_iter"].items()}
    print(f"  phase 17 took {time.perf_counter() - start:.1f} s; the smoke "
          f"{time.perf_counter() - smoke_start:.1f} s", flush=True)

    print(json.dumps({"kernels": list(kernels.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
