"""Masked BerHu loss on the card: the hand-written kernels in
``csrc/berhu.cu`` (forward and backward), bound with ``ctypes``.

The port's counterpart of ``supervised_dispnet_tpu/ops/pallas/losses.py::
berhu_loss_pallas``. The plain PyTorch version of the same function is
``losses/supervised.py::berhu_loss_plain``; ``losses.supervised.berhu_loss``
sends CUDA tensors here and CPU tensors there. This module takes CUDA
tensors only: it launches a kernel or raises.

The kernels take a group: up to ``MAX_PROBLEMS`` predictions of one
target's shape that share the target, the mask and ``c_frac``, each with a
weight (``berhu_forward_many``, ``berhu_backward_many``,
``berhu_loss_many_cuda``). The multi-scale supervised loss is one group, so
a step makes one launch each way. The single-problem entries
(``berhu_forward_stats``, ``berhu_backward``, ``berhu_loss_cuda``) are the
same launches with one problem of weight 1.

``berhu_fwd_launches`` and ``berhu_bwd_launches`` count the launches of the
forward and the backward kernel, so a run can show that it went through
them; ``berhu_fwd_problems`` counts the problems the forward launches
covered.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from collections.abc import Sequence

import torch

from supervised_dispnet_tpu_torch.ops.cuda import _build

MAX_PROBLEMS = 8  # csrc/berhu.cu kMaxProblems
# the forward's grid takes at most this many blocks (the scratch holds their
# partials); the card's co-resident blocks are fewer
SCRATCH_BLOCKS = 2048
# csrc/berhu.cu ``BerhuTable`` in the C layout: pred and dpred pointers,
# weights
_TABLE = struct.Struct(f"@{MAX_PROBLEMS}P{MAX_PROBLEMS}P{MAX_PROBLEMS}f")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # table, np, gt, mask, mask_is_float, n, c_frac, out, scratch,
    # scratch_blocks, device, stream
    "berhu_forward_many": [_P, _I, _P, _P, _I, ctypes.c_long, ctypes.c_float, _P, _P, _I,
                           _I, _P],
    # table, np, gt, mask, mask_is_float, n, stats, grad, device, stream
    "berhu_backward_many": [_P, _I, _P, _P, _I, ctypes.c_long, _P, _P, _I, _P],
}

berhu_fwd_launches = 0
berhu_bwd_launches = 0
berhu_fwd_problems = 0


def _lib() -> ctypes.CDLL:
    return _build.load_library("berhu", _SIGNATURES)


def _stream(index: int) -> int:
    return torch.cuda.current_stream(index).cuda_stream


def _refuse(name: str, t: torch.Tensor, index: int, float32: bool = True):
    if not t.is_cuda:
        raise ValueError(f"berhu kernel: {name} must be a CUDA tensor, got {t.device}")
    if t.get_device() != index:
        raise ValueError(f"berhu kernel: {name} is on {t.device}, gt on cuda:{index}")
    if float32 and t.dtype is not torch.float32:
        raise TypeError(f"berhu kernel: {name} must be float32, got {t.dtype}")
    raise ValueError(f"berhu kernel: {name} must be contiguous")


def _check_group(preds: Sequence[torch.Tensor], gt: torch.Tensor, mask: torch.Tensor,
                 weights: Sequence[float]) -> tuple[torch.Tensor, bool, int]:
    """Validate a group as the kernels take it: 1 to ``MAX_PROBLEMS``
    predictions of gt's shape and as many weights; gt and the predictions
    float32, the mask bool, uint8 or float32, all contiguous on one card.
    Returns the mask as the kernels read it (bool viewed as uint8), whether
    it is float32, and the card's index."""
    n = len(preds)
    if not 1 <= n <= MAX_PROBLEMS:
        raise ValueError(f"berhu kernel: a group holds 1 to {MAX_PROBLEMS} predictions, "
                         f"got {n}")
    if len(weights) != n:
        raise ValueError(f"berhu kernel: {n} predictions but {len(weights)} weights")
    shape = gt.shape
    for k, p in enumerate(preds):
        if p.shape != shape:
            raise ValueError(f"berhu kernel: pred {k} shape {tuple(p.shape)} != gt shape "
                             f"{tuple(shape)}")
    if mask.shape != shape:
        raise ValueError(f"berhu kernel: mask shape {tuple(mask.shape)} != gt shape "
                         f"{tuple(shape)}")
    index = gt.get_device()
    if index < 0 or gt.dtype is not torch.float32 or not gt.is_contiguous():
        _refuse("gt", gt, index)
    if mask.get_device() != index or not mask.is_contiguous():
        _refuse("mask", mask, index, float32=False)
    if mask.dtype is torch.bool:
        mask = mask.view(torch.uint8)
    elif mask.dtype is not torch.uint8 and mask.dtype is not torch.float32:
        raise TypeError(f"berhu kernel: mask must be bool, uint8 or float32, got {mask.dtype}")
    for k, p in enumerate(preds):
        if p.get_device() != index or p.dtype is not torch.float32 or not p.is_contiguous():
            _refuse(f"pred {k}", p, index)
    return mask, mask.dtype is torch.float32, index


def _table(preds: Sequence[torch.Tensor], dpreds: Sequence[torch.Tensor],
           weights: Sequence[float]) -> bytes:
    pad = [0] * (MAX_PROBLEMS - len(preds))
    return _TABLE.pack(*(p.data_ptr() for p in preds), *pad,
                       *(d.data_ptr() for d in dpreds), *([0] * (MAX_PROBLEMS - len(dpreds))),
                       *weights, *([0.0] * len(pad)))


def berhu_forward_many(preds: Sequence[torch.Tensor], gt: torch.Tensor, mask: torch.Tensor,
                       weights: Sequence[float], c_frac: float = 0.2) -> torch.Tensor:
    """Launch the forward over a group of P predictions; returns the device
    tensor (3P + 1,): ``[loss, count, c]`` of each prediction, then the
    weighted total."""
    global berhu_fwd_launches, berhu_fwd_problems
    mask, mask_is_float, index = _check_group(preds, gt, mask, weights)
    n = len(preds)
    # one allocation: the stats, then the forward's scratch
    buf = torch.empty(3 * n + 1 + (2 * n + 1) * SCRATCH_BLOCKS, dtype=torch.float32,
                      device=gt.device)
    out = buf.data_ptr()
    lib = _lib()
    code = lib.berhu_forward_many(
        _table(preds, (), weights), n, gt.data_ptr(), mask.data_ptr(), int(mask_is_float),
        gt.numel(), c_frac, out, out + 4 * (3 * n + 1), SCRATCH_BLOCKS, index, _stream(index))
    berhu_fwd_launches += 1
    berhu_fwd_problems += n
    _build.check(lib, "berhu", "berhu_forward_many", code)
    return buf[:3 * n + 1]


def berhu_backward_many(preds: Sequence[torch.Tensor], gt: torch.Tensor, mask: torch.Tensor,
                        stats: torch.Tensor, weights: Sequence[float],
                        grad: torch.Tensor) -> list[torch.Tensor]:
    """Launch the backward over a group; returns dL/dpred of each prediction
    from the forward's ``stats`` and the upstream gradient ``grad`` of the
    weighted total (one float32 on the card). The gradients are views into
    one allocation, each starting on a 16-byte boundary."""
    global berhu_bwd_launches
    mask, mask_is_float, index = _check_group(preds, gt, mask, weights)
    n = len(preds)
    if (stats.get_device() != index or stats.dtype is not torch.float32
            or not stats.is_contiguous() or stats.numel() < 3 * n):
        raise ValueError(f"berhu kernel: stats must be a contiguous float32 tensor of at "
                         f"least {3 * n} floats on cuda:{index}")
    if grad.get_device() != index or grad.dtype is not torch.float32 or grad.numel() != 1:
        raise ValueError(f"berhu kernel: grad must be one float32 on cuda:{index}")
    numel = gt.numel()
    step = -(-numel // 4) * 4
    buf = torch.empty(n * step, dtype=torch.float32, device=gt.device)
    dpreds = [buf.as_strided(gt.shape, gt.stride(), k * step) for k in range(n)]
    lib = _lib()
    code = lib.berhu_backward_many(
        _table(preds, dpreds, weights), n, gt.data_ptr(), mask.data_ptr(),
        int(mask_is_float), numel, stats.data_ptr(), grad.data_ptr(), index, _stream(index))
    berhu_bwd_launches += 1
    _build.check(lib, "berhu", "berhu_backward_many", code)
    return dpreds


def berhu_forward_stats(pred: torch.Tensor, gt: torch.Tensor,
                        mask: torch.Tensor, c_frac: float = 0.2) -> torch.Tensor:
    """Launch the forward on one prediction; returns the device tensor
    ``[loss, count, c]``."""
    return berhu_forward_many((pred,), gt, mask, (1.0,), c_frac)[:3]


def berhu_backward(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                   stats: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """Launch the backward on one prediction; returns dL/dpred from the
    forward's ``stats`` and the upstream gradient ``grad`` (one float32 on
    the card)."""
    return berhu_backward_many((pred,), gt, mask, stats, (1.0,), grad)[0]


class _BerhuManyFunction(torch.autograd.Function):
    """One node for a group: the grouped forward gives the weighted total,
    the grouped backward every prediction's gradient, and gt's gradient
    (-sum of them) where gt takes one. Inputs: gt, mask, weights, c_frac,
    then the predictions."""

    @staticmethod
    def forward(ctx, gt, mask, weights, c_frac, *preds):
        out = berhu_forward_many(preds, gt, mask, weights, c_frac)
        ctx.weights = weights
        ctx.save_for_backward(gt, mask, out, *preds)
        return out[-1]

    @staticmethod
    def backward(ctx, g):
        gt, mask, out, *preds = ctx.saved_tensors
        dpreds = berhu_backward_many(preds, gt, mask, out, ctx.weights,
                                     g.to(torch.float32).contiguous())
        need = ctx.needs_input_grad
        dgt = -functools.reduce(torch.add, dpreds) if need[0] else None
        return (dgt, None, None, None,
                *(d if need[4 + k] else None for k, d in enumerate(dpreds)))


def berhu_loss_many_cuda(preds: Sequence[torch.Tensor], gt: torch.Tensor, mask: torch.Tensor,
                         weights: Sequence[float], c_frac: float = 0.2) -> torch.Tensor:
    """sum_s weights[s] * BerHu(preds[s], gt, mask), summed in that order,
    through one grouped launch each way; differentiable w.r.t. the
    predictions and gt. Each term has the semantics of
    ``losses.supervised.berhu_loss_plain``."""
    return _BerhuManyFunction.apply(gt, mask, tuple(float(w) for w in weights), c_frac,
                                    *preds)


def berhu_loss_cuda(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                    c_frac: float = 0.2) -> torch.Tensor:
    """Masked BerHu (c = c_frac * max|d|, stop-gradient) through the kernels
    as a group of one; differentiable w.r.t. pred and gt. Same semantics as
    ``losses.supervised.berhu_loss_plain``."""
    return berhu_loss_many_cuda((pred,), gt, mask, (1.0,), c_frac)
