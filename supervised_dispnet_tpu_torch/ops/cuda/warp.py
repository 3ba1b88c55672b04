"""Bilinear warp sampler on the card: the hand-written kernels in
``csrc/warp.cu`` (forward, image+coordinate backward, coordinate-only
backward), bound with ``ctypes``.

The port's counterpart of ``supervised_dispnet_tpu/ops/pallas/warp.py::
bilinear_sample_pallas``. The plain PyTorch version of the same function is
``ops/sampling.py::bilinear_sample``; ``ops/warp.py::sample`` sends CUDA
tensors here and CPU tensors there. This module takes CUDA tensors only: it
launches a kernel or raises.

``warp_fwd_launches``, ``warp_bwd_launches`` and ``warp_bwd_coords_launches``
count the launches of the three entries, so a run can show that it went
through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from supervised_dispnet_tpu_torch.ops.cuda import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SHAPE = [_I, _I, _I, _I, ctypes.c_long, _I, _I, _P]  # B, H, W, C, P, border, device, stream
_SIGNATURES = {
    "warp_forward": [_P, _P, _P, _P, *_SHAPE],
    "warp_backward": [_P, _P, _P, _P, _P, _P, _P, *_SHAPE],
    "warp_backward_coords": [_P, _P, _P, _P, _P, _P, *_SHAPE],
}
PADDING_MODES = ("zeros", "border")

warp_fwd_launches = 0
warp_bwd_launches = 0
warp_bwd_coords_launches = 0


def _lib() -> ctypes.CDLL:
    return _build.load_library("warp", _SIGNATURES)


def _check_inputs(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  padding_mode: str, g: torch.Tensor | None = None) -> tuple:
    """Validate what the kernels take; return the launch's shape arguments
    (B, H, W, C, P, border, device index, stream)."""
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"warp kernel: unknown padding_mode {padding_mode!r}")
    named = [("img", img), ("x", x), ("y", y)] + ([("g", g)] if g is not None else [])
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"warp kernel: {name} must be a CUDA tensor, got {t.device}")
        if t.device != img.device:
            raise ValueError(f"warp kernel: {name} is on {t.device}, img on {img.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"warp kernel: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"warp kernel: {name} must be contiguous")
    if img.dim() != 4 or min(img.shape) < 1:
        raise ValueError(f"warp kernel: img must be (B, H, W, C), got {tuple(img.shape)}")
    B, H, W, C = img.shape
    if x.shape != y.shape or x.dim() < 2 or x.shape[0] != B or x.numel() == 0:
        raise ValueError(f"warp kernel: x {tuple(x.shape)} and y {tuple(y.shape)} must "
                         f"be one (B, ...) shape with B = {B}")
    if g is not None and g.shape != (*x.shape, C):
        raise ValueError(f"warp kernel: g {tuple(g.shape)} != {(*x.shape, C)}")
    return (B, H, W, C, x.numel() // B, int(padding_mode == "border"),
            img.device.index, torch.cuda.current_stream(img.device).cuda_stream)


def warp_forward(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 padding_mode: str = "zeros") -> torch.Tensor:
    """Launch the forward: (B, *S, C) samples of img (B, H, W, C) at x, y
    (B, *S)."""
    global warp_fwd_launches
    shape = _check_inputs(img, x, y, padding_mode)
    out = torch.empty((*x.shape, img.shape[3]), dtype=torch.float32, device=img.device)
    lib = _lib()
    code = lib.warp_forward(img.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
                            *shape)
    warp_fwd_launches += 1
    _build.check(lib, "warp", "warp_forward", code)
    return out


def warp_backward(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                  padding_mode: str = "zeros"):
    """Launch the image+coordinate backward: (dimg, dx, dy) from the upstream
    gradient g (B, *S, C). dimg is summed with atomics, in an order that
    changes from run to run."""
    global warp_bwd_launches
    shape = _check_inputs(img, x, y, padding_mode, g)
    dimg = torch.empty_like(img)
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    lib = _lib()
    code = lib.warp_backward(img.data_ptr(), x.data_ptr(), y.data_ptr(), g.data_ptr(),
                             dimg.data_ptr(), dx.data_ptr(), dy.data_ptr(), *shape)
    warp_bwd_launches += 1
    _build.check(lib, "warp", "warp_backward", code)
    return dimg, dx, dy


def warp_backward_coords(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                         g: torch.Tensor, padding_mode: str = "zeros"):
    """Launch the coordinate-only backward: (dx, dy); img is data."""
    global warp_bwd_coords_launches
    shape = _check_inputs(img, x, y, padding_mode, g)
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    lib = _lib()
    code = lib.warp_backward_coords(img.data_ptr(), x.data_ptr(), y.data_ptr(),
                                    g.data_ptr(), dx.data_ptr(), dy.data_ptr(), *shape)
    warp_bwd_coords_launches += 1
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
