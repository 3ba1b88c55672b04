"""The port's image resizes on the host, in numpy: what ``cv2.resize``
computes with ``INTER_AREA`` and ``INTER_LINEAR``, without ``cv2``, which the
port does not depend on.

Each resize is separable: a (target x source) weight matrix per axis, built
as OpenCV builds its tables (its float32 weights, its 1e-3 cut-offs of
slivers at an area cell's edges), applied as two matrix products. At a
non-integer ratio such as KITTI's 375x1242 -> 128x416, ``INTER_AREA`` weights
each source pixel by its fractional overlap with the target cell, which
``F.interpolate(mode="area")`` (whole-pixel bins) does not. When either
axis grows, OpenCV's ``INTER_AREA`` is no area mean: both axes take a
two-tap table of its own (``area_linear_table``). ``resize_area_uint8``
follows OpenCV's uint8 arithmetic step by step (its summation order, its
rounding, its 11-bit fixed point), so its frames equal cv2's bit for bit.
"""

from __future__ import annotations

import math

import numpy as np


def area_linear_table(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """(source index, float32 fraction) of each target pixel in the two-tap
    table that ``cv2.resize`` builds for ``INTER_AREA`` when a scale is below
    one (an upscale on either axis): source ``floor(d * src / dst)``, fraction
    ``(d + 1) - (s + 1) * dst / src`` wrapped to [0, 1), both clamped at the
    last source pixel."""
    scale, inv = src / dst, dst / src
    d = np.arange(dst)
    sx = np.floor(d * scale).astype(np.int64)
    fx = ((d + 1) - (sx + 1) * inv).astype(np.float32)
    fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx)).astype(np.float32)
    edge = sx >= src - 1
    fx[edge] = 0.0
    sx[edge] = src - 1
    return sx, fx


def area_linear_weights(src: int, dst: int) -> np.ndarray:
    """``area_linear_table`` as a (dst, src) float32 weight matrix."""
    sx, fx = area_linear_table(src, dst)
    w = np.zeros((dst, src), np.float32)
    rows = np.arange(dst)
    w[rows, sx] += np.float32(1.0) - fx
    w[rows, np.minimum(sx + 1, src - 1)] += fx
    return w


def area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) float32 ``INTER_AREA`` weights of a downscale (dst <= src),
    as OpenCV's ``computeResizeAreaTab`` makes them."""
    if dst > src:
        raise ValueError(f"area_weights is a downscale's table ({src} -> {dst}); "
                         "an upscale takes area_linear_weights")
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


def _area_tables(H: int, W: int, h: int, w: int):
    """OpenCV's ``INTER_AREA`` weights of both axes: area means when neither
    axis grows, else the two-tap tables on both axes."""
    if h <= H and w <= W:
        return area_weights(H, h), area_weights(W, w)
    return area_linear_weights(H, h), area_linear_weights(W, w)


def resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` of float32
    (H, W), (H, W, C) or (B, H, W, C), down or up."""
    img = _check(img)
    grey = img.ndim == 2
    x = img[..., None] if grey else img
    out = _resize(x, *_area_tables(x.shape[-3], x.shape[-2], h, w))
    return out[..., 0] if grey else out


def resize_linear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` of float32
    (H, W), (H, W, C) or (B, H, W, C), up or down."""
    img = _check(img)
    grey = img.ndim == 2
    x = img[..., None] if grey else img
    out = _resize(x, linear_weights(x.shape[-3], h), linear_weights(x.shape[-2], w))
    return out[..., 0] if grey else out


def _area_linear_uint8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """The two-tap ``INTER_AREA`` tables on (H, W, C) uint8 in OpenCV's fixed
    point (``resizeGeneric_`` with ``HResizeLinear`` / ``VResizeLinear``):
    11-bit weights, rows summed in int, then
    ``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2``."""
    H, W = img.shape[:2]
    sy, fy = area_linear_table(H, h)
    sx, fx = area_linear_table(W, w)

    def fixed(f):  # OpenCV's saturate_cast<short>(weight * 2048)
        return (np.rint((np.float32(1.0) - f) * np.float32(2048)).astype(np.int64),
                np.rint(f * np.float32(2048)).astype(np.int64))

    a0, a1 = fixed(fx)
    b0, b1 = fixed(fy)
    x = img.astype(np.int64)
    rows = x[:, sx] * a0[:, None] + x[:, np.minimum(sx + 1, W - 1)] * a1[:, None]
    r0, r1 = rows[sy] >> 4, rows[np.minimum(sy + 1, H - 1)] >> 4
    out = (((b0[:, None, None] * r0) >> 16) + ((b1[:, None, None] * r1) >> 16) + 2) >> 2
    return out.astype(np.uint8)


def _area_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """``area_weights`` as OpenCV's tap list: (dst, T) source indices in
    increasing order and their float32 weights, padded with weight 0."""
    wm = area_weights(src, dst)
    nz = [np.nonzero(r)[0] for r in wm]
    idx = np.zeros((dst, max(len(n) for n in nz)), np.int64)
    alpha = np.zeros(idx.shape, np.float32)
    for d, n in enumerate(nz):
        idx[d, :len(n)] = n
        alpha[d, :len(n)] = wm[d, n]
    return idx, alpha


def _area_mean_uint8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """An ``INTER_AREA`` downscale of (H, W, C) uint8 in OpenCV's arithmetic.
    Integer ratios (``resizeAreaFast_``): the block's int sum times float32
    ``1 / area``, rounded half to even; halving 1, 3 or 4 channels,
    ``(sum + 2) >> 2``. Else (``ResizeArea_Invoker``): each row's taps summed
    left to right in float32, the rows' weighted sums top to bottom, rounded
    half to even."""
    H, W, C = img.shape
    if H % h == 0 and W % w == 0:
        ky, kx = H // h, W // w
        s = img.reshape(h, ky, w, kx, C).astype(np.int64).sum(axis=(1, 3))
        if ky == kx == 2 and C in (1, 3, 4):
            return ((s + 2) >> 2).astype(np.uint8)
        out = s.astype(np.float32) * (np.float32(1) / np.float32(ky * kx))
    else:
        xi, xa = _area_taps(W, w)
        yi, ya = _area_taps(H, h)
        f = img.astype(np.float32)
        rows = np.zeros((H, w, C), np.float32)
        for t in range(xi.shape[1]):
            rows = rows + f[:, xi[:, t], :] * xa[None, :, t, None]
        out = np.zeros((h, w, C), np.float32)
        for t in range(yi.shape[1]):
            out = out + ya[:, t, None, None] * rows[yi[:, t]]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_area_uint8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` of a uint8
    (H, W) or (H, W, C) image, down or up, bit for bit: OpenCV's own
    summation order and rounding for a downscale, its fixed-point two-tap
    tables when either axis grows."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize_area_uint8 takes uint8 (H, W) or (H, W, C), "
                         f"got {img.dtype} {img.shape}")
    x = img[..., None] if img.ndim == 2 else img
    if h > x.shape[0] or w > x.shape[1]:
        out = _area_linear_uint8(x, h, w)
    else:
        out = _area_mean_uint8(x, h, w)
    return out[..., 0] if img.ndim == 2 else out
