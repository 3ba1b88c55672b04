"""Shared model building blocks: the disparity head, flax-matched BatchNorm
and the initialisers. The port of ``supervised_dispnet_tpu/models/common.py``
(NCHW inside the modules)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# Disparity head output scaling (reference: DispNetS alpha/beta constants).
DISP_ALPHA = 10.0
DISP_BETA = 0.01


def xavier_uniform_(conv: nn.Conv2d, generator: torch.Generator | None) -> None:
    """flax ``xavier_uniform`` kernel, zero bias (flax ``nn.Conv`` defaults)."""
    nn.init.xavier_uniform_(conv.weight, generator=generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)


def kaiming_normal_(conv: nn.Conv2d, generator: torch.Generator | None) -> None:
    """flax ``kaiming_normal``: truncated normal at +-2 sigma, fan-in scaled so
    the truncated distribution has variance 2 / fan_in."""
    fan_in = conv.weight[0].numel()
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``
    semantics. ``torch.nn.BatchNorm2d`` updates ``running_var`` with the
    unbiased batch variance; flax (and so the JAX package) uses the biased
    one, which this module does. Normalisation in train mode uses the biased
    batch variance in both. State-dict layout is torch's."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class DispHead(nn.Sequential):
    """3x3 conv -> sigmoid -> alpha * s + beta disparity head, always in
    float32 (disparity feeds 1/d and the losses). A ``Sequential`` so its conv
    is named ``0``, as in the reference state dict (``predict_disp{s}.0``)."""

    def __init__(self, in_channels: int, alpha: float = DISP_ALPHA,
                 beta: float = DISP_BETA):
        super().__init__(nn.Conv2d(in_channels, 1, 3, padding=1))
        self.alpha = alpha
        self.beta = beta

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.alpha * torch.sigmoid(self[0](x.to(torch.float32))) + self.beta
