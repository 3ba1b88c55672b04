"""Bilinear image sampling in plain PyTorch, the port of
``supervised_dispnet_tpu/ops/sampling.py``.

``bilinear_sample`` is the per-corner, floor-based form (the JAX package's
``_bilinear_sample_4gather``): four corner gathers, each weighted by its
bilinear weight, zeroed per corner outside the image ('zeros') or taken at
coordinates clamped to the image first ('border'). Autograd of this form
gives the coordinate gradient of the Pallas warp kernel
(``ops/pallas/warp.py::_coord_grads``): dx = wy0 (c01 - c00) + wy1 (c11 - c10),
zeroed outside [0, W-1] in 'border' mode. It is what the CUDA kernels in
``csrc/warp.cu`` compute, their oracle on the card, and the version the CPU
runs. Layout is NHWC, as in the JAX package.
"""

from __future__ import annotations

import torch


def _corner_setup(x: torch.Tensor, y: torch.Tensor, H: int, W: int, padding_mode: str):
    """Integer corners (int64), bilinear weights and per-corner validity, as
    ``ops/pallas/warp.py::_corner_setup``: 'border' clamps the coordinates
    first; 'zeros' zeroes the weight of each out-of-bounds corner. Returns
    (x0, x1, y0, y1, wx0, wx1, wy0, wy1, vx0, vx1, vy0, vy1)."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unknown padding_mode: {padding_mode!r}")
    if padding_mode == "border":
        x = x.clamp(0.0, W - 1)
        y = y.clamp(0.0, H - 1)
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0f, y - y0f
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    # far out-of-view coordinates stay out of bounds but fit the integer cast
    x0 = x0f.detach().clamp(-2.0, W + 1.0).to(torch.int64)
    y0 = y0f.detach().clamp(-2.0, H + 1.0).to(torch.int64)
    x1, y1 = x0 + 1, y0 + 1
    vx0, vx1 = (x0 >= 0) & (x0 <= W - 1), (x1 >= 0) & (x1 <= W - 1)
    vy0, vy1 = (y0 >= 0) & (y0 <= H - 1), (y1 >= 0) & (y1 <= H - 1)
    if padding_mode == "border":
        x0, x1 = x0.clamp(0, W - 1), x1.clamp(0, W - 1)
        y0, y1 = y0.clamp(0, H - 1), y1.clamp(0, H - 1)
        vx0 = vx1 = vy0 = vy1 = torch.ones_like(vx0)
    return x0, x1, y0, y1, wx0, wx1, wy0, wy1, vx0, vx1, vy0, vy1


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinearly sample ``img`` (B, H, W, C) at float pixel coordinates
    ``x``, ``y`` (B, Ho, Wo) ((0, 0) is the center of the top-left pixel);
    returns (B, Ho, Wo, C). Differentiable in img, x and y."""
    B, H, W, C = img.shape
    out_shape = x.shape
    x = x.reshape(B, -1).to(img.dtype)
    y = y.reshape(B, -1).to(img.dtype)
    x0, x1, y0, y1, wx0, wx1, wy0, wy1, vx0, vx1, vy0, vy1 = _corner_setup(
        x, y, H, W, padding_mode)
    flat = img.reshape(B, H * W, C)

    def corner(ix, iy, w, valid):
        idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1))[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, idx) * (w * valid.to(w.dtype))[..., None]

    out = (corner(x0, y0, wx0 * wy0, vx0 & vy0) + corner(x1, y0, wx1 * wy0, vx1 & vy0)
           + corner(x0, y1, wx0 * wy1, vx0 & vy1) + corner(x1, y1, wx1 * wy1, vx1 & vy1))
    return out.reshape(*out_shape, C)


def unnormalize_coords(gx: torch.Tensor, gy: torch.Tensor, H: int, W: int,
                       align_corners: bool):
    """Map normalised [-1, 1] grid coordinates to pixel coordinates (torch
    ``grid_sample`` convention)."""
    if align_corners:
        return (gx + 1.0) * 0.5 * (W - 1), (gy + 1.0) * 0.5 * (H - 1)
    return ((gx + 1.0) * W - 1.0) * 0.5, ((gy + 1.0) * H - 1.0) * 0.5


def grid_sample(img: torch.Tensor, grid: torch.Tensor, padding_mode: str = "zeros",
                align_corners: bool = False) -> torch.Tensor:
    """``F.grid_sample`` semantics (bilinear) on NHWC: img (B, H, W, C), grid
    (B, Ho, Wo, 2) with [..., 0] = x and [..., 1] = y in [-1, 1]."""
    H, W = img.shape[1], img.shape[2]
    x, y = unnormalize_coords(grid[..., 0], grid[..., 1], H, W, align_corners)
    return bilinear_sample(img, x, y, padding_mode=padding_mode)
