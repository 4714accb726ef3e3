"""Metric logger with the reference's artifact layout, a copy of the JAX
package's utils/logger.py.

Creates timestamped `models_*/plots_*/metrics_*` directories under
`save_data_path`, accumulates per-iteration metrics in dict-of-lists, and
writes `hyperparameter.txt` (JSON) plus `<name>.npy` and `<name>.pt` per
metric. TensorBoard (tensorboardX) is optional.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Dict, List

import numpy as np
import torch


class Logger:
    def __init__(self, tensorboard_dir: str | None = None) -> None:
        self.metrics: Dict[str, List[float]] = {}
        self.hyperparameter: Dict[str, str] = {}
        self._tb = None
        if tensorboard_dir is not None:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:  # tensorboard is optional
                pass

    def log(self, metric_name: str, value: float) -> None:
        values = self.metrics.setdefault(metric_name, [])
        values.append(float(value))
        if self._tb is not None:
            self._tb.add_scalar(metric_name, float(value), len(values))

    def save_metrics(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "hyperparameter.txt"), "w") as f:
            json.dump(self.hyperparameter, f)
        for name, values in self.metrics.items():
            arr = np.asarray(values, dtype=np.float32)
            np.save(os.path.join(path, f"{name}.npy"), arr)
            torch.save(torch.tensor(arr), os.path.join(path, f"{name}.pt"))


def make_run_dirs(save_data_path: str = "saved_data") -> Dict[str, str]:
    """Timestamped models/plots/metrics dirs, with a shell-friendly stamp (no
    spaces or colons)."""
    stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S.%f")
    paths = {
        kind: os.path.join(save_data_path, f"{kind}_{stamp}")
        for kind in ("models", "plots", "metrics")
    }
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    return paths
