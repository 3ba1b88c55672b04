"""Bilinear resize, the port of ``supervised_dispnet_tpu/ops/resize.py``.

``F.interpolate(mode="bilinear", align_corners=False)`` matches
``jax.image.resize(..., "bilinear")`` only when upsampling: JAX antialiases
when it downsamples and ``F.interpolate`` does not. So the two bilinear
functions here raise on a downsampling request. ``downsample2x_avg`` is the
exact 2x2 mean of the photometric pyramid, not a resize.

Under spatial partitioning (``parallel/spatial.py``) the upsample takes this
rank's rows with a row of each neighbour and crops its output back to its
own rows; the height must then grow by a whole factor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from supervised_dispnet_tpu_torch.parallel import spatial


def interpolate_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear upsample of (B, C, H, W) to (B, C, h, w), half-pixel centers."""
    H, W = x.shape[-2:]
    if (H, W) == (h, w):
        return x
    if h < H or w < W:
        raise NotImplementedError(
            f"bilinear downsampling ({H}x{W} -> {h}x{w}) is not ported: "
            "jax.image.resize antialiases there and F.interpolate does not")
    if spatial.active() is None:
        return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    if h % H:
        raise ValueError(f"spatial partitioning: a bilinear upsample of {H} rows to {h} "
                         "is not by a whole factor")
    f = h // H
    return spatial.upsample_rows(
        lambda t: F.interpolate(t, size=(t.shape[2] * f, w), mode="bilinear",
                                align_corners=False), x, f)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear upsample of (B, H, W, C) to (B, h, w, C)."""
    return interpolate_bilinear(x.permute(0, 3, 1, 2), h, w).permute(0, 2, 3, 1)


def downsample2x_avg(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean of (B, H, W, C) -> (B, H / 2, W / 2, C), the photometric
    loss's image pyramid (JAX ``ops/resize.py::downsample2x_avg``). Exact
    average pooling, not an antialiased resize; H and W must be even, as
    there."""
    B, H, W, C = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"downsample2x_avg needs even height and width, got {H}x{W}")
    return x.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))
