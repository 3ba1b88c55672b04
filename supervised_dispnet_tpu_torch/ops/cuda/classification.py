"""Masked depth-bin cross-entropy on the card: the hand-written kernels in
``csrc/ce.cu`` (forward and backward), bound with ``ctypes``.

The port's counterpart of ``supervised_dispnet_tpu/ops/pallas/losses.py::
depth_classification_loss_pallas``. The plain PyTorch version of the same
function is ``losses/classification.py::depth_classification_loss_plain``;
``losses.classification.depth_classification_loss`` sends CUDA tensors here
and CPU tensors there. This module takes CUDA tensors only: it launches the
kernels or raises.

The kernels read the logits in place through their strides. Two layouts are
taken as they are: contiguous (..., K), and the (B, H, W, K) view of an NCHW
tensor, which is what the model's conv head and ``ops.resize`` hand over
(bin k of a pixel at ``k * H * W``); any other layout is copied to
contiguous first. The backward writes dL/dlogits in the logits' layout.

``ce_fwd_launches`` and ``ce_bwd_launches`` count the launches of the
forward and the backward entry, so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import ctypes

import torch

from supervised_dispnet_tpu_torch.ops.cuda import _build

_P = ctypes.c_void_p
_L = ctypes.c_long
# logits, labels, mask, mask_is_float, B, P, K, batch / pixel / bin strides
_INPUTS = [_P, _P, _P, ctypes.c_int, _L, _L, ctypes.c_int, _L, _L, _L]
_SIGNATURES = {
    "ce_forward": [*_INPUTS, ctypes.c_int, _P, _P, ctypes.c_int, _P],
    "ce_backward": [*_INPUTS, _P, _P, _P, ctypes.c_int, _P],
}
THREADS = 256  # kThreads in ce.cu: one pixel a thread
MAX_BLOCKS = 1024

ce_fwd_launches = 0
ce_bwd_launches = 0


def _lib() -> ctypes.CDLL:
    return _build.load_library("ce", _SIGNATURES)


def is_nchw_view(logits: torch.Tensor) -> bool:
    """True for the (B, H, W, K) ``permute(0, 2, 3, 1)`` view of a
    contiguous NCHW tensor."""
    return logits.dim() == 4 and logits.permute(0, 3, 1, 2).is_contiguous()


def kernel_layout(logits: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    """The logits as the kernels read them, and (B, P, K, batch stride,
    pixel stride, bin stride) with P the pixels of a batch entry. Contiguous
    logits and the NCHW view are read in place; others are copied to
    contiguous."""
    if logits.dim() < 2:
        raise ValueError(f"ce kernel: logits must be (B, ..., K), got {tuple(logits.shape)}")
    if not (logits.is_contiguous() or is_nchw_view(logits)):
        logits = logits.contiguous()
    B, K = logits.shape[0], logits.shape[-1]
    flat = logits.view(B, -1, K)
    return logits, (B, flat.shape[1], K, *flat.stride())


def _check_inputs(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """Validate what the kernels take; return the mask as they read it
    (bool viewed as uint8) and whether it is float32."""
    for name, t in (("logits", logits), ("labels", labels), ("mask", mask)):
        if t.device.type != "cuda":
            raise ValueError(f"ce kernel: {name} must be a CUDA tensor, got {t.device}")
        if t.device != logits.device:
            raise ValueError(f"ce kernel: {name} is on {t.device}, logits on {logits.device}")
    if logits.dtype != torch.float32:
        raise TypeError(f"ce kernel: logits must be float32, got {logits.dtype}")
    if logits.numel() == 0:
        raise ValueError("ce kernel: logits are empty")
    for name, t in (("labels", labels), ("mask", mask)):
        if t.shape != logits.shape[:-1]:
            raise ValueError(f"ce kernel: {name} shape {tuple(t.shape)} != logits shape "
                             f"{tuple(logits.shape[:-1])} without the bins")
        if not t.is_contiguous():
            raise ValueError(f"ce kernel: {name} must be contiguous")
    if labels.dtype != torch.int32:
        raise TypeError(f"ce kernel: labels must be int32, got {labels.dtype}")
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    elif mask.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"ce kernel: mask must be bool, uint8 or float32, got {mask.dtype}")
    return mask, mask.dtype == torch.float32


def forward_blocks(n: int) -> int:
    """Grid of the forward's partial-sum pass for ``n`` pixels."""
    return max(1, min(MAX_BLOCKS, -(-n // THREADS)))


def ce_forward_stats(logits: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Launch the forward; returns the device tensor ``[loss, count]``."""
    global ce_fwd_launches
    mask, mask_is_float = _check_inputs(logits, labels, mask)
    logits, shape = kernel_layout(logits)
    nblocks = forward_blocks(labels.numel())
    scratch = torch.empty(2 * nblocks, dtype=torch.float32, device=logits.device)
    out = torch.empty(2, dtype=torch.float32, device=logits.device)
    lib = _lib()
    code = lib.ce_forward(
        logits.data_ptr(), labels.data_ptr(), mask.data_ptr(), int(mask_is_float), *shape,
        nblocks, scratch.data_ptr(), out.data_ptr(), logits.device.index,
        torch.cuda.current_stream(logits.device).cuda_stream)
    ce_fwd_launches += 1
    _build.check(lib, "ce", "ce_forward", code)
    return out


def ce_backward(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                stats: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """Launch the backward; returns dL/dlogits, in the logits' layout, from
    the forward's ``stats`` and the upstream gradient ``grad`` (one float32
    on the card)."""
    global ce_bwd_launches
    mask, mask_is_float = _check_inputs(logits, labels, mask)
    logits, shape = kernel_layout(logits)
    for name, t in (("stats", stats), ("grad", grad)):
        if t.device != logits.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"ce kernel: {name} must be a contiguous float32 tensor on "
                             f"{logits.device}")
    if stats.numel() != 2 or grad.numel() != 1:
        raise ValueError("ce kernel: stats holds 2 floats and grad 1")
    dlogits = torch.empty_like(logits)  # the same strides: both layouts are dense
    lib = _lib()
    code = lib.ce_backward(
        logits.data_ptr(), labels.data_ptr(), mask.data_ptr(), int(mask_is_float), *shape,
        stats.data_ptr(), grad.data_ptr(), dlogits.data_ptr(), logits.device.index,
        torch.cuda.current_stream(logits.device).cuda_stream)
    ce_bwd_launches += 1
    _build.check(lib, "ce", "ce_backward", code)
    return dlogits


class _CrossEntropyFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, mask):
        stats = ce_forward_stats(logits, labels, mask)
        ctx.save_for_backward(logits, labels, mask, stats)
        return stats[0]

    @staticmethod
    def backward(ctx, g):
        logits, labels, mask, stats = ctx.saved_tensors
        dlogits = ce_backward(logits, labels, mask, stats, g.to(torch.float32).contiguous())
        return dlogits if ctx.needs_input_grad[0] else None, None, None


def cross_entropy_cuda(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Masked CE over the last axis of ``logits`` (B, ..., K) against int
    ``labels`` in [0, K) through the kernels: sum(mask * (logsumexp(logits)
    - logits[label])) / max(sum(mask), 1); differentiable w.r.t. logits. A
    label outside [0, K) gives NaN. Same semantics as
    ``losses.classification.depth_classification_loss_plain``."""
    logits, _ = kernel_layout(logits.to(torch.float32))
    return _CrossEntropyFunction.apply(logits, labels.to(torch.int32).contiguous(),
                                       mask.contiguous())
