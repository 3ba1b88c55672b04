"""Shared model building blocks: the conv+ELU blocks, the disparity head,
flax-matched BatchNorm and the initialisers. The port of
``supervised_dispnet_tpu/models/common.py`` (NCHW inside the modules).

The blocks are ``nn.Sequential``s so that their layers carry the reference
state dict's names (``conv{i}.0`` / ``.2``, ``upconv{i}.0``, ``iconv{i}.0``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from supervised_dispnet_tpu_torch.ops.fused_upconv import upconv2x_fused

# Disparity head output scaling (reference: DispNetS alpha/beta constants).
DISP_ALPHA = 10.0
DISP_BETA = 0.01


def xavier_uniform_(conv: nn.Conv2d | nn.ConvTranspose2d,
                    generator: torch.Generator | None) -> None:
    """flax ``xavier_uniform`` kernel, zero bias (flax ``nn.Conv`` defaults).
    The bound depends on fan_in + fan_out only, so a transposed conv's
    (I, O, kh, kw) weight gets flax's bound too."""
    nn.init.xavier_uniform_(conv.weight, generator=generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)


def init_convs_xavier_(module: nn.Module, generator: torch.Generator | None) -> None:
    """xavier-uniform, zero-bias init of every (transposed) conv of ``module``,
    in ``named_modules`` order."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            xavier_uniform_(m, generator)


class ConvELU(nn.Sequential):
    """k x k conv (padding (k-1)/2, optional stride) + ELU."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__(nn.Conv2d(in_channels, out_channels, kernel, stride=stride,
                                   padding=(kernel - 1) // 2), nn.ELU())


class DownsampleConv(nn.Sequential):
    """stride-2 conv + ELU, then stride-1 conv + ELU (reference
    ``downsample_conv``: layers ``0`` and ``2``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3):
        pad = (kernel - 1) // 2
        super().__init__(
            nn.Conv2d(in_channels, out_channels, kernel, stride=2, padding=pad), nn.ELU(),
            nn.Conv2d(out_channels, out_channels, kernel, padding=pad), nn.ELU())


class UpConvELU(nn.Sequential):
    """2x transposed-conv upsample + ELU: ``ConvTranspose2d(k=3, stride=2,
    padding=1, output_padding=1)``, which is what the JAX package's
    ``nn.ConvTranspose(padding=((1, 2), (1, 2)))`` with a spatially flipped
    kernel computes. The output is exactly twice the input."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(nn.ConvTranspose2d(in_channels, out_channels, 3, stride=2,
                                            padding=1, output_padding=1), nn.ELU())


def crop_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Crop NCHW ``x`` to ``ref``'s height and width (a transposed conv
    overshoots odd sizes by one)."""
    return x[:, :, : ref.shape[2], : ref.shape[3]]


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


def fused_upsample_conv(conv: nn.Conv2d, h: torch.Tensor, skip: torch.Tensor | None,
                        target_hw: tuple[int, int], stage: int) -> torch.Tensor:
    """``conv`` (3x3, padding 1) of (2x bilinear upsample of ``h`` to
    ``target_hw``, concat ``skip``) before its activation, without the
    upsample (``ops/fused_upconv.py::upconv2x_fused``): the weight's input
    channels are split as the concat lays them out, ``h``'s first. The
    decoder stage ``stage`` must upsample exactly 2x."""
    if tuple(target_hw) != (2 * h.shape[2], 2 * h.shape[3]):
        raise ValueError(
            "fused_upsample needs an exact 2x stage geometry (input height "
            f"and width divisible by 32); decoder stage {stage} upsamples "
            f"{tuple(h.shape[2:])} to {tuple(target_hw)}")
    ch = h.shape[1]
    y = upconv2x_fused(h, conv.weight[:, :ch])
    if skip is None:
        return y + conv.bias[:, None, None]
    return y + F.conv2d(skip, conv.weight[:, ch:], conv.bias, padding=1)
