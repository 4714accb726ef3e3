"""Device selection, the float32 numerics the port runs under, and host
arrays' copies to the device."""

from __future__ import annotations

import contextlib
import subprocess
from typing import Dict, List, Sequence

import numpy as np
import torch

STAGE_ALIGN = 512  # bytes: each array's offset in a slot, and so its views'
_COPIERS: Dict[torch.device, "StagedCopier"] = {}
_TO_DEVICE_COUNTS = {"staged": 0, "plain": 0}


def resolve_device(name: str | torch.device) -> torch.device:
    """torch.device(name); raises when CUDA is asked for and absent, so no
    entry point continues on the CPU unasked."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; pass "
            "--device cpu (or device='cpu') to run on the CPU")
    return device


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (the first card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def exact_float32():
    """float32 convolutions without TF32 (cuDNN allows TF32 by default);
    float32 matmuls must not use TF32 either."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is set; "
                           "the float32 parity mode needs full float32")
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        yield


class StagedCopier:
    """Host arrays to one CUDA device through a ring of two page-locked
    slots and a copy stream of its own, so that the copy of one batch runs
    under the kernels the caller queued before it.

    A slot is one flat pinned byte buffer, allocated at its first use and
    grown only when a call needs more bytes; the arrays of a call are views
    into it at STAGE_ALIGN-byte offsets, so a shorter batch reuses it. Each
    call, in order: (a) waits on the host until the slot's last copy is done
    and the caller's stream has run what it held at the previous call (in a
    train loop, the step that read this slot's batch), so the host runs at
    most one batch ahead and at most two batches of input live on the card;
    (b) copies the arrays into the slot on the host (`Tensor.copy_`, which
    casts to the asked dtype); (c) allocates the device tensors with the
    copy stream current and copies each view into them there,
    `non_blocking`; (d) records the slot's copy event, makes the caller's
    current stream wait on it and ties each tensor to that stream
    (`record_stream`), so the caching allocator keeps its block until the
    caller's work on it is done. Nothing here synchronises the device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.buffers: List[torch.Tensor] = [torch.empty(0, dtype=torch.uint8)
                                            for _ in range(2)]
        self.copied = [torch.cuda.Event() for _ in range(2)]
        self.released = [torch.cuda.Event() for _ in range(2)]
        self.turn = 0

    def __call__(self, arrays: Sequence[np.ndarray],
                 dtypes: Sequence[torch.dtype]) -> List[torch.Tensor]:
        slot, self.turn = self.turn, self.turn ^ 1
        current = torch.cuda.current_stream(self.device)
        # the caller's stream now holds the step that read the other slot
        self.released[self.turn].record(current)
        self.released[slot].synchronize()
        self.copied[slot].synchronize()
        sources = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        sizes = [src.numel() * dtype.itemsize
                 for src, dtype in zip(sources, dtypes)]
        starts = np.cumsum([0] + [-(-n // STAGE_ALIGN) * STAGE_ALIGN
                                  for n in sizes]).tolist()
        if self.buffers[slot].numel() < starts[-1]:
            self.buffers[slot] = torch.empty(starts[-1], dtype=torch.uint8,
                                             pin_memory=True)
        views = []
        for src, dtype, start, size in zip(sources, dtypes, starts, sizes):
            view = self.buffers[slot][start:start + size].view(dtype)
            views.append(view.view(src.shape).copy_(src))
        with torch.cuda.stream(self.stream):
            out = [torch.empty(view.shape, dtype=view.dtype,
                               device=self.device) for view in views]
            for dst, view in zip(out, views):
                dst.copy_(view, non_blocking=True)
            self.copied[slot].record(self.stream)
        current.wait_event(self.copied[slot])
        for dst in out:
            dst.record_stream(current)
        return out


def arrays_to_device(arrays: Sequence[np.ndarray],
                     dtypes: Sequence[torch.dtype],
                     device: torch.device) -> List[torch.Tensor]:
    """Host arrays -> tensors of `dtypes` on `device`, values unchanged but
    for the cast. On a CUDA device through the device's `StagedCopier`:
    asynchronous, the caller's current stream waits for the copies, and the
    host blocks only while a slot's previous batch is still in use. On any
    other device a plain `torch.from_numpy(a).to(device, dtype)` (on the CPU
    a tensor that shares the array's memory where the dtype matches)."""
    device = torch.device(device)
    if device.type != "cuda":
        _TO_DEVICE_COUNTS["plain"] += 1
        return [torch.from_numpy(np.asarray(a)).to(device, dtype)
                for a, dtype in zip(arrays, dtypes)]
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _COPIERS:
        _COPIERS[device] = StagedCopier(device)
    _TO_DEVICE_COUNTS["staged"] += 1
    return _COPIERS[device](arrays, dtypes)


def to_device_counts() -> Dict[str, int]:
    """How many `arrays_to_device` calls took each path since the process
    started: {"staged": n, "plain": m}."""
    return dict(_TO_DEVICE_COUNTS)
