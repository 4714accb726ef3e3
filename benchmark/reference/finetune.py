"""The plain float32 reference of the VGG-16 Places365 fine-tune step
(arXiv:1409.1556 configuration D, Zhou et al., Places, TPAMI 2017): the
classifier in training mode with its two Dropout(0.5) layers, the mean
cross-entropy of the logits and one Adam update."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference.common import Precision, adam_
from benchmark.reference.gan import Forward, Tensors, Widths, vgg_forward


class FineTuner:
    """Steps its own copy of the VGG-16's parameters; `run` returns the
    step's loss, `first_grads` holds the first step's gradients."""

    def __init__(self, cfg: dict, weights: Tensors, lr: float,
                 precision: str = "float32", remat: bool = True,
                 batch_rows: Optional[int] = None):
        self.w = Widths(cfg)
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in weights.items()}
        self.lr, self.q, self.remat = lr, Precision(precision), remat
        self.batch_rows = batch_rows  # a planted fault: the rows the loss
        # is taken over (the forward runs on every row)
        self.moments: dict = {}
        self.steps = 0
        self.first_grads: Dict[str, torch.Tensor] = {}
        self.first_output = None  # step 1's logits

    def run(self, images: torch.Tensor, labels: torch.Tensor,
            dropout_masks: Sequence[torch.Tensor]) -> float:
        """images (B, 3, H, W) as the loader gives them; labels (B,) int."""
        return float(self.step(images, labels, dropout_masks))

    def step(self, images: torch.Tensor, labels: torch.Tensor,
             dropout_masks: Sequence[torch.Tensor]) -> torch.Tensor:
        f = Forward(self.params, {}, True, self.q)
        logits = vgg_forward(f, self.w, images.float(), dropout_masks,
                             remat=self.remat)[-1]
        keep = slice(0, self.batch_rows)
        loss = F.cross_entropy(logits[keep], labels.long()[keep])
        if self.steps == 0:
            self.first_output = logits.detach()
        grads = dict(zip(self.params, torch.autograd.grad(
            loss, list(self.params.values()))))
        self.steps += 1
        adam_(self.params, grads, self.moments, self.steps, self.lr)
        self.params = {k: v.requires_grad_(True)
                       for k, v in self.params.items()}
        if self.steps == 1:
            self.first_grads = grads
        return loss.detach()
