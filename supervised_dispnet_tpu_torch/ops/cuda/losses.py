"""Masked BerHu loss on the card: the hand-written kernel in
``csrc/berhu.cu`` (forward and backward), bound with ``ctypes``.

The port's counterpart of ``supervised_dispnet_tpu/ops/pallas/losses.py::
berhu_loss_pallas``. The plain PyTorch version of the same function is
``losses/supervised.py::berhu_loss_plain``; ``losses.supervised.berhu_loss``
sends CUDA tensors here and CPU tensors there. This module takes CUDA
tensors only: it launches the kernel or raises.

``berhu_fwd_launches`` and ``berhu_bwd_launches`` count the launches of the
forward and the backward entry, so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from supervised_dispnet_tpu_torch.ops.cuda import _build

_P = ctypes.c_void_p
_SIGNATURES = {
    "berhu_forward": [_P, _P, _P, ctypes.c_int, ctypes.c_long, ctypes.c_float,
                      ctypes.c_int, _P, _P, ctypes.c_int, _P],
    "berhu_backward": [_P, _P, _P, ctypes.c_int, ctypes.c_long, _P, _P, _P,
                       ctypes.c_int, _P],
}
THREADS = 256  # kThreads in berhu.cu
ITEMS_PER_THREAD = 4  # forward grid: about this many elements per thread
MAX_BLOCKS = 1024

berhu_fwd_launches = 0
berhu_bwd_launches = 0


def _lib() -> ctypes.CDLL:
    return _build.load_library("berhu", _SIGNATURES)


def _check_inputs(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor):
    """Validate what the kernel takes; return the mask as the kernel reads it
    (bool viewed as uint8) and whether it is float32."""
    for name, t in (("pred", pred), ("gt", gt), ("mask", mask)):
        if t.device.type != "cuda":
            raise ValueError(f"berhu kernel: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.device != pred.device:
            raise ValueError(f"berhu kernel: {name} is on {t.device}, pred on "
                             f"{pred.device}")
        if t.shape != pred.shape:
            raise ValueError(f"berhu kernel: {name} shape {tuple(t.shape)} != "
                             f"pred shape {tuple(pred.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"berhu kernel: {name} must be contiguous")
    for name, t in (("pred", pred), ("gt", gt)):
        if t.dtype != torch.float32:
            raise TypeError(f"berhu kernel: {name} must be float32, got {t.dtype}")
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    elif mask.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"berhu kernel: mask must be bool, uint8 or float32, "
                        f"got {mask.dtype}")
    return mask, mask.dtype == torch.float32


def forward_blocks(n: int) -> int:
    """Grid of the forward passes for ``n`` elements."""
    per_block = THREADS * ITEMS_PER_THREAD
    return max(1, min(MAX_BLOCKS, -(-n // per_block)))


def berhu_forward_stats(pred: torch.Tensor, gt: torch.Tensor,
                        mask: torch.Tensor, c_frac: float = 0.2) -> torch.Tensor:
    """Launch the forward; returns the device tensor ``[loss, count, c]``."""
    global berhu_fwd_launches
    mask, mask_is_float = _check_inputs(pred, gt, mask)
    n = pred.numel()
    nblocks = forward_blocks(n)
    scratch = torch.empty(2 * nblocks + 1, dtype=torch.float32, device=pred.device)
    out = torch.empty(3, dtype=torch.float32, device=pred.device)
    lib = _lib()
    code = lib.berhu_forward(
        pred.data_ptr(), gt.data_ptr(), mask.data_ptr(), int(mask_is_float), n,
        c_frac, nblocks, scratch.data_ptr(), out.data_ptr(), pred.device.index,
        torch.cuda.current_stream(pred.device).cuda_stream)
    berhu_fwd_launches += 1
    _build.check(lib, "berhu", "berhu_forward", code)
    return out


def berhu_backward(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                   stats: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """Launch the backward; returns dL/dpred from the forward's ``stats`` and
    the upstream gradient ``grad`` (one float32 on the card)."""
    global berhu_bwd_launches
    mask, mask_is_float = _check_inputs(pred, gt, mask)
    for name, t in (("stats", stats), ("grad", grad)):
        if t.device != pred.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"berhu kernel: {name} must be a contiguous float32 "
                             f"tensor on {pred.device}")
    if stats.numel() != 3 or grad.numel() != 1:
        raise ValueError("berhu kernel: stats holds 3 floats and grad 1")
    dpred = torch.empty_like(pred)
    lib = _lib()
    code = lib.berhu_backward(
        pred.data_ptr(), gt.data_ptr(), mask.data_ptr(), int(mask_is_float),
        pred.numel(), stats.data_ptr(), grad.data_ptr(), dpred.data_ptr(),
        pred.device.index, torch.cuda.current_stream(pred.device).cuda_stream)
    berhu_bwd_launches += 1
    _build.check(lib, "berhu", "berhu_backward", code)
    return dpred


class _BerhuFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, gt, mask, c_frac):
        stats = berhu_forward_stats(pred, gt, mask, c_frac)
        ctx.save_for_backward(pred, gt, mask, stats)
        return stats[0]

    @staticmethod
    def backward(ctx, g):
        pred, gt, mask, stats = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        dpred = berhu_backward(pred, gt, mask, stats, g)
        dgt = -dpred if ctx.needs_input_grad[1] else None
        return dpred if ctx.needs_input_grad[0] else None, dgt, None, None


def berhu_loss_cuda(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                    c_frac: float = 0.2) -> torch.Tensor:
    """Masked BerHu (c = c_frac * max|d|, stop-gradient) through the kernel;
    differentiable w.r.t. pred and gt. Same semantics as
    ``losses.supervised.berhu_loss_plain``."""
    return _BerhuFunction.apply(pred, gt, mask, c_frac)
