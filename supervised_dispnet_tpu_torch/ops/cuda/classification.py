"""Masked depth-bin cross-entropy on the card: the hand-written kernels in
``csrc/ce.cu`` (forward and backward), bound with ``ctypes``.

The port's counterpart of ``supervised_dispnet_tpu/ops/pallas/losses.py::
depth_classification_loss_pallas``. The plain PyTorch version of the same
function is ``losses/classification.py::depth_classification_loss_plain``;
``losses.classification.depth_classification_loss`` sends CUDA tensors here
and CPU tensors there. ``ce_forward_plain`` and ``ce_backward_plain`` are
the plain versions of the two kernels one by one, with their split (the
forward's per-pixel logsumexp feeds the backward). The kernel entries take
CUDA tensors only: they launch the kernels or raise.

The kernels read the logits in place through their strides. Two layouts are
taken as they are: contiguous (..., K), and the (B, H, W, K) view of an NCHW
tensor, which is what the model's conv head and ``ops.resize`` hand over
(bin k of a pixel at ``k * H * W``); any other layout is copied to
contiguous first. The backward writes dL/dlogits in the logits' layout.
``vector_path`` says, from shapes, strides and addresses alone, whether the
kernels take 4 pixels a thread with 16-byte accesses or one pixel a thread.

``ce_fwd_launches`` and ``ce_bwd_launches`` count the launches of the
forward and the backward entry, so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from supervised_dispnet_tpu_torch.ops.cuda import _build

_P = ctypes.c_void_p
_L = ctypes.c_long
_I = ctypes.c_int
# logits, labels, mask, mask_is_float, B, P, K, batch / pixel / bin strides, vec
_INPUTS = [_P, _P, _P, _I, _L, _L, _I, _L, _L, _L, _I]
_SIGNATURES = {
    # lse, partials, capacity, ticket, out, device, stream
    "ce_forward": [*_INPUTS, _P, _P, _I, _P, _P, _I, _P],
    # lse, stats, grad, dlogits, device, stream
    "ce_backward": [*_INPUTS, _P, _P, _P, _P, _I, _P],
}
MAX_BLOCKS = 1024  # the forward's grid at most: the per-block partials it has room for

ce_fwd_launches = 0
ce_bwd_launches = 0
_tickets: dict[tuple[int, int], torch.Tensor] = {}


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


def _vector(logits: torch.Tensor, shape: tuple[int, ...], labels: torch.Tensor,
            mask: torch.Tensor) -> bool:
    _, P, _, sb, sp, sk = shape
    return (sp == 1 and P % 4 == 0 and sb % 4 == 0 and sk % 4 == 0
            and logits.data_ptr() % 16 == 0 and labels.data_ptr() % 16 == 0
            and mask.data_ptr() % (4 * mask.element_size()) == 0)


def vector_path(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> bool:
    """Whether the kernels take 4 consecutive pixels a thread with 16-byte
    loads and stores: pixel stride 1 (the NCHW view), P and the batch and
    bin strides multiples of 4, logits and labels at 16-byte addresses and
    the mask at 4 of its elements. Otherwise (contiguous (..., K) logits, a
    ragged P, an offset tensor) one pixel a thread. Decided from shapes,
    strides and addresses alone, so it answers for CPU tensors too."""
    laid_out, shape = kernel_layout(logits)
    return _vector(laid_out, shape, labels, mask)


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


def _ticket(device: torch.device, stream: torch.cuda.Stream) -> torch.Tensor:
    """The forward's counter word for ``device`` and ``stream``: zeroed once
    here; the block that finishes a launch last sets it back to 0."""
    key = (device.index, stream.cuda_stream)
    ticket = _tickets.get(key)
    if ticket is None:
        ticket = _tickets[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return ticket


def ce_forward(logits: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward; returns the device tensors ``[loss, count]`` and
    the per-pixel logsumexp ``lse`` (2, *labels.shape): ``lse[0]`` rounded
    to float32 and ``lse[1]`` its rounding error (``ce_forward_plain``)."""
    global ce_fwd_launches
    mask, mask_is_float = _check_inputs(logits, labels, mask)
    logits, shape = kernel_layout(logits)
    vec = _vector(logits, shape, labels, mask)
    dev = logits.device
    stream = torch.cuda.current_stream(dev)
    lse = torch.empty((2, *labels.shape), dtype=torch.float32, device=dev)
    out = torch.empty(2 + 2 * MAX_BLOCKS, dtype=torch.float32, device=dev)  # stats, partials
    lib = _lib()
    code = lib.ce_forward(
        logits.data_ptr(), labels.data_ptr(), mask.data_ptr(), int(mask_is_float), *shape,
        int(vec), lse.data_ptr(), out[2:].data_ptr(), MAX_BLOCKS,
        _ticket(dev, stream).data_ptr(), out.data_ptr(), dev.index, stream.cuda_stream)
    ce_fwd_launches += 1
    _build.check(lib, "ce", "ce_forward", code)
    return out[:2], lse


def ce_backward(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                lse: torch.Tensor, stats: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """Launch the backward; returns dL/dlogits, in the logits' layout, from
    the forward's ``lse`` and ``stats`` and the upstream gradient ``grad``
    (one float32 on the card)."""
    global ce_bwd_launches
    mask, mask_is_float = _check_inputs(logits, labels, mask)
    logits, shape = kernel_layout(logits)
    for name, t in (("lse", lse), ("stats", stats), ("grad", grad)):
        if t.device != logits.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"ce kernel: {name} must be a contiguous float32 tensor on "
                             f"{logits.device}")
    if lse.shape != (2, *labels.shape) or stats.numel() != 2 or grad.numel() != 1:
        raise ValueError("ce kernel: lse is (2, *labels.shape), stats holds 2 floats and "
                         "grad 1")
    dlogits = torch.empty_like(logits)  # the same strides: both layouts are dense
    vec = _vector(logits, shape, labels, mask) and lse.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(logits.device)
    lib = _lib()
    code = lib.ce_backward(
        logits.data_ptr(), labels.data_ptr(), mask.data_ptr(), int(mask_is_float), *shape,
        int(vec), lse.data_ptr(), stats.data_ptr(), grad.data_ptr(), dlogits.data_ptr(),
        logits.device.index, stream.cuda_stream)
    ce_bwd_launches += 1
    _build.check(lib, "ce", "ce_backward", code)
    return dlogits


def ce_forward_plain(logits: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: ``[loss, count]`` and
    ``lse`` (2, *labels.shape), where ``lse[0]`` = m + log s rounded and
    ``lse[1]`` = (m - lse[0]) + log s, its rounding error, for the row's
    max m and s = sum exp(x - m) (a row of only -inf subtracts 0, not m:
    ``lse[0]`` = -inf). Labels must lie in [0, K)."""
    x = logits.to(torch.float32)
    m = x.amax(-1)
    base = torch.where(m == -math.inf, torch.zeros_like(m), m)
    ls = torch.log(torch.exp(x - base[..., None]).sum(-1))
    hi = m + ls
    lo = (m - hi) + ls
    xy = torch.gather(x, -1, labels.to(torch.int64)[..., None])[..., 0]
    w = mask.to(torch.float32)
    count = w.sum()
    loss = (((m - xy) + ls) * w).sum() / count.clamp(min=1.0)
    return torch.stack([loss, count]), torch.stack([hi, lo])


def ce_backward_plain(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                      lse: torch.Tensor, stats: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch: (exp((x - lse[0]) -
    lse[1]) - onehot(y)) * m * g / max(count, 1), from ``ce_forward_plain``'s
    (or the forward kernel's) ``lse`` and ``stats``."""
    x = logits.to(torch.float32)
    p = torch.exp((x - lse[0][..., None]) - lse[1][..., None])
    onehot = torch.nn.functional.one_hot(labels.to(torch.int64), x.shape[-1])
    w = mask.to(torch.float32) * (g.to(torch.float32) / stats[1].clamp(min=1.0))
    return (p - onehot.to(torch.float32)) * w[..., None]


class _CrossEntropyFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, mask):
        stats, lse = ce_forward(logits, labels, mask)
        ctx.save_for_backward(logits, labels, mask, lse, stats)
        return stats[0]

    @staticmethod
    def backward(ctx, g):
        logits, labels, mask, lse, stats = ctx.saved_tensors
        dlogits = ce_backward(logits, labels, mask, lse, stats,
                              g.to(torch.float32).contiguous())
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
