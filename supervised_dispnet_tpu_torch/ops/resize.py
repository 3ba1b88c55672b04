"""Bilinear resize, the port of ``supervised_dispnet_tpu/ops/resize.py``.

``F.interpolate(mode="bilinear", align_corners=False)`` matches
``jax.image.resize(..., "bilinear")`` only when upsampling: JAX antialiases
when it downsamples and ``F.interpolate`` does not. So both functions here
raise on a downsampling request.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def interpolate_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear upsample of (B, C, H, W) to (B, C, h, w), half-pixel centers."""
    H, W = x.shape[-2:]
    if (H, W) == (h, w):
        return x
    if h < H or w < W:
        raise NotImplementedError(
            f"bilinear downsampling ({H}x{W} -> {h}x{w}) is not ported: "
            "jax.image.resize antialiases there and F.interpolate does not")
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear upsample of (B, H, W, C) to (B, h, w, C)."""
    return interpolate_bilinear(x.permute(0, 3, 1, 2), h, w).permute(0, 2, 3, 1)
