"""Bilinear warp sampler on the card: the hand-written kernels in
``csrc/warp.cu`` (forward, image+coordinate backward, coordinate-only
backward), bound with ``ctypes``.

The port's counterpart of ``supervised_dispnet_tpu/ops/pallas/warp.py::
bilinear_sample_pallas``. The plain PyTorch version of the same function is
``ops/sampling.py::bilinear_sample``; ``ops/warp.py::sample`` and
``sample_many`` send CUDA tensors here and CPU tensors there. This module
takes CUDA tensors only: it launches a kernel or raises.

The forward and the coordinate-only backward also come grouped
(``warp_forward_many``, ``warp_backward_coords_many``): one launch covers up
to ``MAX_PROBLEMS`` sampling problems of any shapes, so the photometric
loss's 4 scales x R refs cost one call a step each way. The single-problem
entries launch the same kernels with a one-entry table. The
image+coordinate backward (``warp_backward``) takes one problem; a block
covers a 2-D tile of its output and, where the tile's corners are in
bounds and scattered, gathers its image gradient in a shared-memory window
(``tile_plan`` picks the tile and the window's width).

``warp_fwd_launches``, ``warp_bwd_launches`` and ``warp_bwd_coords_launches``
count the kernels' launches, so a run can show that it went through them;
``warp_fwd_problems`` and ``warp_bwd_coords_problems`` count the problems
those launches covered.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from collections.abc import Sequence

import torch

from supervised_dispnet_tpu_torch.ops.cuda import _build

THREADS = 256  # csrc/warp.cu kThreads: output pixels a block
MAX_PROBLEMS = 16  # csrc/warp.cu kMaxProblems: problems a grouped launch
TILE_PIXELS = 256  # csrc/warp.cu kTilePixels: output pixels a block of warp_backward
WIN_FLOATS = 12 * 1024 - 96  # csrc/warp.cu kWinFloats: floats of its shared window
# csrc/warp.cu ``WarpProblem``, one row of a grouped launch's table, in the
# C layout: img, x, y, g, out, dx, dy pointers, long P, int B, H, W, C,
# block_start, padding to 8 bytes
PROBLEM_ROW = "7Pl5i4x"
_TABLES = [struct.Struct("@" + PROBLEM_ROW * n) for n in range(MAX_PROBLEMS + 1)]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SHAPE = [_I, _I, _I, _I, ctypes.c_long, _I, _I, _P]  # B, H, W, C, P, border, device, stream
# B, H, W, C, Ho, Wo, tile_w, win_w, border, device, stream
_TILED = [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
_GROUP = [_P, _I, _I, _I, _P]  # table, n, border, device, stream
_SIGNATURES = {
    "warp_forward": [_P, _P, _P, _P, *_SHAPE],
    "warp_backward": [_P, _P, _P, _P, _P, _P, _P, *_TILED],
    "warp_backward_coords": [_P, _P, _P, _P, _P, _P, *_SHAPE],
    "warp_forward_many": _GROUP,
    "warp_backward_coords_many": _GROUP,
}
PADDING_MODES = ("zeros", "border")

warp_fwd_launches = 0
warp_bwd_launches = 0
warp_bwd_coords_launches = 0
warp_fwd_problems = 0
warp_bwd_coords_problems = 0


def _lib() -> ctypes.CDLL:
    return _build.load_library("warp", _SIGNATURES)


def _border(padding_mode: str) -> int:
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"warp kernel: unknown padding_mode {padding_mode!r}")
    return int(padding_mode == "border")


def _stream(index: int) -> int:
    return torch.cuda.current_stream(index).cuda_stream


def _refuse(name: str, t: torch.Tensor, index: int):
    if not t.is_cuda:
        raise ValueError(f"warp kernel: {name} must be a CUDA tensor, got {t.device}")
    if t.get_device() != index:
        raise ValueError(f"warp kernel: {name} is on {t.device}, the group on cuda:{index}")
    if t.dtype is not torch.float32:
        raise TypeError(f"warp kernel: {name} must be float32, got {t.dtype}")
    raise ValueError(f"warp kernel: {name} must be contiguous")


def _check_inputs(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  g: torch.Tensor | None = None,
                  index: int | None = None) -> tuple[int, int, int, int, int]:
    """Validate one problem as the kernels take it (CUDA, float32,
    contiguous, consistent shapes), all on the card of ``index`` (img's by
    default); return its shape (B, H, W, C, P)."""
    if index is None:
        index = img.get_device()
    for name, t in (("img", img), ("x", x), ("y", y), ("g", g)):
        if t is not None and (t.get_device() != index or index < 0
                              or t.dtype is not torch.float32 or not t.is_contiguous()):
            _refuse(name, t, index)
    shape, xy = img.shape, x.shape
    if len(shape) != 4 or min(shape) < 1:
        raise ValueError(f"warp kernel: img must be (B, H, W, C), got {tuple(shape)}")
    if xy != y.shape or len(xy) < 2 or xy[0] != shape[0] or min(xy) < 1:
        raise ValueError(f"warp kernel: x {tuple(xy)} and y {tuple(y.shape)} must "
                         f"be one (B, ...) shape with B = {shape[0]}")
    if g is not None and g.shape != (*xy, shape[3]):
        raise ValueError(f"warp kernel: g {tuple(g.shape)} != {(*xy, shape[3])}")
    B, H, W, C = shape
    return B, H, W, C, x.numel() // B


def _check_group(imgs: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
                 ys: Sequence[torch.Tensor], gs: Sequence[torch.Tensor] | None = None):
    """Validate every problem of a group; return their shapes and the
    group's device index."""
    n = len(imgs)
    if n == 0 or len(xs) != n or len(ys) != n or (gs is not None and len(gs) != n):
        raise ValueError(f"warp kernel: a group needs as many x, y (and g) as images, "
                         f"at least one: {n} images, {len(xs)} x, {len(ys)} y"
                         + ("" if gs is None else f", {len(gs)} g"))
    index = imgs[0].get_device()
    if gs is None:
        shapes = [_check_inputs(img, x, y, None, index) for img, x, y in zip(imgs, xs, ys)]
    else:
        shapes = [_check_inputs(*p, index) for p in zip(imgs, xs, ys, gs)]
    return shapes, index


def _empty_many(shapes: Sequence[tuple[int, ...]], device: torch.device) -> list[torch.Tensor]:
    """Contiguous float32 tensors of ``shapes``, views into one allocation
    (a group's outputs: one call of the caching allocator, not one each)."""
    buf = torch.empty(sum(math.prod(s) for s in shapes), dtype=torch.float32, device=device)
    outs, offset = [], 0
    for shape in shapes:
        strides, size = [], 1
        for d in reversed(shape):
            strides.append(size)
            size *= d
        outs.append(buf.as_strided(shape, strides[::-1], offset))
        offset += size
    return outs


def plan_groups(blocks: Sequence[int], max_problems: int = MAX_PROBLEMS
                ) -> list[list[tuple[int, int]]]:
    """The grouped launches for problems of ``blocks`` blocks each: the
    problems largest first (ties in their order), cut into launches of at
    most ``max_problems``. Each launch is a list of (problem index,
    block_start), block_start being the blocks of the problems before it in
    that launch, as ``csrc/warp.cu`` checks."""
    order = sorted(range(len(blocks)), key=blocks.__getitem__, reverse=True)  # stable
    launches = []
    for k in range(0, len(order), max_problems):
        start, launch = 0, []
        for i in order[k:k + max_problems]:
            launch.append((i, start))
            start += blocks[i]
        launches.append(launch)
    return launches


def window_stride(w: int, C: int) -> int:
    """Floats of shared memory a window row of ``w`` pixels of C channels
    takes in ``csrc/warp.cu`` (``window_stride``): w * C rounded up to a
    float4, and 4 floats for the row's alignment pad."""
    return (w * C + 3) // 4 * 4 + 4


@functools.lru_cache(maxsize=256)
def tile_plan(Ho: int, Wo: int, C: int, tile_pixels: int = TILE_PIXELS,
              win_floats: int = WIN_FLOATS) -> tuple[int, int, int]:
    """The image+coordinate backward's launch plan for an (Ho, Wo) output of
    C channels: (tile_w, tile_h, win_w). A block covers a tile of tile_w x
    tile_h = ``tile_pixels`` output pixels, tile_w a power of two from 32
    (a warp on one row) up: the fewest tiles that cover (Ho, Wo), of those
    the squarest (the smallest footprint in the image under a smooth warp).
    win_w is the widest window, in pixels, whose rows, as many as the
    tile's aspect asks, fit ``win_floats`` floats; the kernel clips a tile's
    corner box to it where the box does not fit (0: never clip)."""
    best = None
    tile_w = 32
    while tile_w <= tile_pixels:
        tile_h = tile_pixels // tile_w
        key = (-(-Ho // tile_h) * -(-Wo // tile_w), tile_w + tile_h)
        if best is None or key < best[0]:
            best = (key, tile_w, tile_h)
        tile_w *= 2
    _, tile_w, tile_h = best
    win_w = 0
    while (-(-(win_w + 1) * (tile_h + 1) // (tile_w + 1))
           * window_stride(win_w + 1, C) <= win_floats):
        win_w += 1
    return tile_w, tile_h, win_w


def _tables(shapes, pointers):
    """The packed table of each launch: (table bytes, problems in it).
    ``pointers[i]`` holds problem i's seven ``WarpProblem`` pointers (0 for
    none)."""
    for launch in plan_groups([-(-B * P // THREADS) for B, _, _, _, P in shapes]):
        row = []
        for i, start in launch:
            B, H, W, C, P = shapes[i]
            row += [*pointers[i], P, B, H, W, C, start]
        yield _TABLES[len(launch)].pack(*row), len(launch)


def warp_forward_many(imgs: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
                      ys: Sequence[torch.Tensor], padding_mode: str = "zeros"
                      ) -> list[torch.Tensor]:
    """Launch the forward over a group: for each problem the (B, *S, C)
    samples of imgs[i] (B, H, W, C) at xs[i], ys[i] (B, *S); one launch per
    ``MAX_PROBLEMS`` problems."""
    global warp_fwd_launches, warp_fwd_problems
    border = _border(padding_mode)
    shapes, index = _check_group(imgs, xs, ys)
    outs = _empty_many([(*x.shape, s[3]) for x, s in zip(xs, shapes)], imgs[0].device)
    pointers = [(img.data_ptr(), x.data_ptr(), y.data_ptr(), 0, out.data_ptr(), 0, 0)
                for img, x, y, out in zip(imgs, xs, ys, outs)]
    lib, stream = _lib(), _stream(index)
    for table, n in _tables(shapes, pointers):
        code = lib.warp_forward_many(table, n, border, index, stream)
        warp_fwd_launches += 1
        warp_fwd_problems += n
        _build.check(lib, "warp", "warp_forward_many", code)
    return outs


def warp_backward_coords_many(imgs: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
                              ys: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                              padding_mode: str = "zeros"
                              ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Launch the coordinate-only backward over a group: (dx, dy) of each
    problem from its upstream gradient gs[i] (B, *S, C); the images are
    data. One launch per ``MAX_PROBLEMS`` problems."""
    global warp_bwd_coords_launches, warp_bwd_coords_problems
    border = _border(padding_mode)
    shapes, index = _check_group(imgs, xs, ys, gs)
    flat = _empty_many([x.shape for x in xs for _ in (0, 1)], xs[0].device)
    grads = list(zip(flat[0::2], flat[1::2]))  # dx, dy of each problem
    pointers = [(img.data_ptr(), x.data_ptr(), y.data_ptr(), g.data_ptr(), 0,
                 dx.data_ptr(), dy.data_ptr())
                for img, x, y, g, (dx, dy) in zip(imgs, xs, ys, gs, grads)]
    lib, stream = _lib(), _stream(index)
    for table, n in _tables(shapes, pointers):
        code = lib.warp_backward_coords_many(table, n, border, index, stream)
        warp_bwd_coords_launches += 1
        warp_bwd_coords_problems += n
        _build.check(lib, "warp", "warp_backward_coords_many", code)
    return grads


def warp_forward(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 padding_mode: str = "zeros") -> torch.Tensor:
    """Launch the forward on one problem: (B, *S, C) samples of img
    (B, H, W, C) at x, y (B, *S)."""
    global warp_fwd_launches, warp_fwd_problems
    border, index = _border(padding_mode), img.get_device()
    shape = _check_inputs(img, x, y, None, index)
    out = torch.empty((*x.shape, shape[3]), dtype=torch.float32, device=img.device)
    lib = _lib()
    code = lib.warp_forward(img.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
                            *shape, border, index, _stream(index))
    warp_fwd_launches += 1
    warp_fwd_problems += 1
    _build.check(lib, "warp", "warp_forward", code)
    return out


def warp_backward(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                  padding_mode: str = "zeros"):
    """Launch the image+coordinate backward: (dimg, dx, dy) from the upstream
    gradient g (B, *S, C), read as (B, Ho, Wo, C) with Wo = S[-1]. dimg is
    summed with atomics, in an order that changes from run to run."""
    global warp_bwd_launches
    border, index = _border(padding_mode), img.get_device()
    B, H, W, C, P = _check_inputs(img, x, y, g, index)
    Wo = x.shape[-1]
    tile_w, _, win_w = tile_plan(P // Wo, Wo, C)
    dimg = torch.empty_like(img)
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    lib = _lib()
    code = lib.warp_backward(img.data_ptr(), x.data_ptr(), y.data_ptr(), g.data_ptr(),
                             dimg.data_ptr(), dx.data_ptr(), dy.data_ptr(), B, H, W, C,
                             P // Wo, Wo, tile_w, win_w, border, index, _stream(index))
    warp_bwd_launches += 1
    _build.check(lib, "warp", "warp_backward", code)
    return dimg, dx, dy


def warp_backward_coords(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                         g: torch.Tensor, padding_mode: str = "zeros"):
    """Launch the coordinate-only backward on one problem: (dx, dy); img is
    data."""
    global warp_bwd_coords_launches, warp_bwd_coords_problems
    border, index = _border(padding_mode), img.get_device()
    shape = _check_inputs(img, x, y, g, index)
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    lib = _lib()
    code = lib.warp_backward_coords(img.data_ptr(), x.data_ptr(), y.data_ptr(),
                                    g.data_ptr(), dx.data_ptr(), dy.data_ptr(), *shape,
                                    border, index, _stream(index))
    warp_bwd_coords_launches += 1
    warp_bwd_coords_problems += 1
    _build.check(lib, "warp", "warp_backward_coords", code)
    return dx, dy


class _WarpFunction(torch.autograd.Function):
    """Forward kernel; the backward is the image+coordinate kernel when img
    takes a gradient (``diff_img``), else the coordinate-only kernel."""

    @staticmethod
    def forward(ctx, img, x, y, padding_mode, diff_img):
        ctx.padding_mode = padding_mode
        ctx.diff_img = diff_img
        ctx.save_for_backward(img, x, y)
        return warp_forward(img, x, y, padding_mode)

    @staticmethod
    def backward(ctx, g):
        img, x, y = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        dimg = None
        if ctx.diff_img and ctx.needs_input_grad[0]:
            dimg, dx, dy = warp_backward(img, x, y, g, ctx.padding_mode)
        else:
            dx, dy = warp_backward_coords(img, x, y, g, ctx.padding_mode)
        return (dimg, dx if ctx.needs_input_grad[1] else None,
                dy if ctx.needs_input_grad[2] else None, None, None)


class _WarpManyFunction(torch.autograd.Function):
    """A group of samples whose images are data: the grouped forward, and
    the grouped coordinate-only backward for every problem. Inputs are
    ``padding_mode`` then (img, x, y) of each problem, flat; outputs the
    samples in that order. No gradient reaches an image."""

    @staticmethod
    def forward(ctx, padding_mode, *flat):
        ctx.padding_mode = padding_mode
        ctx.save_for_backward(*flat)
        return tuple(warp_forward_many(flat[0::3], flat[1::3], flat[2::3], padding_mode))

    @staticmethod
    def backward(ctx, *gs):
        flat = ctx.saved_tensors
        gs = [g.to(torch.float32).contiguous() for g in gs]
        grads = warp_backward_coords_many(flat[0::3], flat[1::3], flat[2::3], gs,
                                          ctx.padding_mode)
        need = ctx.needs_input_grad
        out = [None]
        for k, (dx, dy) in enumerate(grads):
            out += [None, dx if need[2 + 3 * k] else None, dy if need[3 + 3 * k] else None]
        return tuple(out)


def bilinear_sample_cuda(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                         padding_mode: str = "zeros", diff_img: bool = True) -> torch.Tensor:
    """Bilinear sample of img (B, H, W, C) at pixel coordinates x, y
    (B, Ho, Wo) through the kernels; returns (B, Ho, Wo, C) float32. Same
    semantics as ``ops.sampling.bilinear_sample``. ``diff_img=False`` treats
    img as data: no gradient reaches it, and the backward runs the
    coordinate-only kernel."""
    img = img.to(torch.float32).contiguous()
    if not diff_img:
        img = img.detach()
    return _WarpFunction.apply(img, x.to(torch.float32).contiguous(),
                               y.to(torch.float32).contiguous(), padding_mode, diff_img)


def bilinear_sample_many_cuda(imgs: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
                              ys: Sequence[torch.Tensor], padding_mode: str = "zeros"
                              ) -> list[torch.Tensor]:
    """Bilinear samples of imgs[i] (B, H, W, C) at xs[i], ys[i] (B, Ho, Wo),
    all through one grouped launch each way (per ``MAX_PROBLEMS``); the
    images are data. Returns the (B, Ho, Wo, C) float32 samples in order."""
    flat = [t if t.dtype is torch.float32 and t.is_contiguous()
            else t.to(torch.float32).contiguous()
            for p in zip(imgs, xs, ys, strict=True) for t in p]
    return list(_WarpManyFunction.apply(padding_mode, *flat))
