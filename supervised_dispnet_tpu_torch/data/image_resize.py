"""The eval pipeline's image resizes on the host, in numpy: what
``cv2.resize`` computes for float32 images with ``INTER_AREA`` (a downscale)
and ``INTER_LINEAR``, without ``cv2``, which the port does not depend on.

Each resize is separable: a (target x source) weight matrix per axis, built
as OpenCV builds its tables (its float32 weights, its 1e-3 cut-offs of
slivers at an area cell's edges), applied as two matrix products. At a
non-integer ratio such as KITTI's 375x1242 -> 128x416, ``INTER_AREA`` weights
each source pixel by its fractional overlap with the target cell, which
``F.interpolate(mode="area")`` (whole-pixel bins) does not.
"""

from __future__ import annotations

import math

import numpy as np


def area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) float32 ``INTER_AREA`` weights of a downscale, as OpenCV's
    ``computeResizeAreaTab`` makes them."""
    if dst > src:
        raise NotImplementedError(
            f"area upscale ({src} -> {dst}) is not ported: cv2.INTER_AREA "
            "switches to another algorithm there")
    scale = 1.0 / (dst / src)  # OpenCV's 1 / inv_scale
    w = np.zeros((dst, src), np.float32)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] = np.float32((s1 - f1) / cell)
        w[d, s1:s2] = np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[d, s2] = np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return w


def linear_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) float32 ``INTER_LINEAR`` weights: half-pixel centres, two
    taps, clamped at the edges, as OpenCV computes them for float images."""
    scale = 1.0 / (dst / src)
    fx = (np.arange(dst) + 0.5) * scale - 0.5  # in float64, as OpenCV computes it
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx).astype(np.float32)
    low, high = sx < 0, sx >= src - 1
    fx[low | high] = 0.0
    sx = np.clip(sx, 0, src - 1)
    w = np.zeros((dst, src), np.float32)
    rows = np.arange(dst)
    w[rows, sx] += np.float32(1.0) - fx
    w[rows, np.minimum(sx + 1, src - 1)] += fx
    return w


def _resize(img: np.ndarray, wy: np.ndarray, wx: np.ndarray) -> np.ndarray:
    """Apply per-axis weights to (..., H, W, C) float32."""
    out = np.matmul(wy, img.reshape(*img.shape[:-2], -1))  # (..., h, W*C)
    out = out.reshape(*out.shape[:-1], img.shape[-2], img.shape[-1])
    return np.einsum("jw,...hwc->...hjc", wx, out, optimize=True)


def _check(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.float32 or img.ndim not in (2, 3, 4):
        raise ValueError(f"resize takes float32 (H, W), (H, W, C) or (B, H, W, C), "
                         f"got {img.dtype} {img.shape}")
    return img


def resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` of float32
    (H, W), (H, W, C) or (B, H, W, C) with h <= H and w <= W; an upscale
    raises ``NotImplementedError``."""
    img = _check(img)
    grey = img.ndim == 2
    x = img[..., None] if grey else img
    out = _resize(x, area_weights(x.shape[-3], h), area_weights(x.shape[-2], w))
    return out[..., 0] if grey else out


def resize_linear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` of float32
    (H, W), (H, W, C) or (B, H, W, C), up or down."""
    img = _check(img)
    grey = img.ndim == 2
    x = img[..., None] if grey else img
    out = _resize(x, linear_weights(x.shape[-3], h), linear_weights(x.shape[-2], w))
    return out[..., 0] if grey else out


def resize_area_uint8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize`` of a uint8 image with ``INTER_AREA`` (a downscale): the
    float32 area means rounded to the nearest level, ties to even, as cv2
    rounds them at a non-integer ratio. At some integer ratios cv2 takes a
    fast path that rounds ties up, so a pixel there may differ by one level."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_area_uint8 takes uint8, got {img.dtype}")
    out = resize_area(img.astype(np.float32), h, w)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
