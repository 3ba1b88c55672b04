"""Supervised depth losses over sparse GT masks.

The port of ``supervised_dispnet_tpu/losses/supervised.py``. ``pred`` and
``gt`` are (B, H, W) metric depth; ``mask`` is a (B, H, W) bool/float
validity mask (KITTI GT is sparse LiDAR). Every reduction is a masked mean
with an explicit valid-pixel count. Each loss returns a 0-d float32 tensor.

On a data-parallel mesh (``parallel/mesh.py``) every masked sum and count,
and BerHu's threshold, are taken over the global batch, as the JAX mesh
takes them: the scale-invariant loss is not linear in the ranks' sums.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import torch

from supervised_dispnet_tpu_torch.ops.cuda.losses import berhu_loss_cuda, berhu_loss_many_cuda
from supervised_dispnet_tpu_torch.ops.resize import interpolate_bilinear
from supervised_dispnet_tpu_torch.parallel.mesh import all_reduce_max, global_sums


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(torch.float32)
    total, count = global_sums((x.to(torch.float32) * m).sum(), m.sum())
    return total / count.clamp(min=1.0)


def l1_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean absolute depth error."""
    return _masked_mean((pred - gt).abs(), mask)


def berhu_loss_plain(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                     c_frac: float = 0.2, c: torch.Tensor | None = None) -> torch.Tensor:
    """Reverse Huber (BerHu) with adaptive threshold c = c_frac * max|d|,
    in plain PyTorch: the reference the CUDA kernel is held against, and the
    version that runs on the CPU.

    L(d) = |d|                 if |d| <= c
         = (d^2 + c^2) / (2c)  otherwise

    ``c`` (a 0-d float32 tensor) gives the threshold instead: the plain
    version of the kernel's given-threshold mode. On a mesh, max|d| is the
    global batch's (max(c_frac M, 1e-6) commutes with a max over ranks).
    """
    m = mask.to(torch.float32)
    d = (pred - gt).to(torch.float32) * m
    absd = d.abs()
    if c is None:
        c = all_reduce_max((c_frac * absd.max()).clamp(min=1e-6).detach())
    quad = (d * d + c * c) / (2.0 * c)
    return _masked_mean(torch.where(absd <= c, absd, quad), mask)


def berhu_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
               c_frac: float = 0.2) -> torch.Tensor:
    """BerHu: through the CUDA kernel for CUDA tensors (``ops/cuda/losses.py``),
    the plain version for CPU tensors."""
    if pred.device.type == "cuda":
        return berhu_loss_cuda(pred, gt, mask, c_frac)
    if pred.device.type == "cpu":
        return berhu_loss_plain(pred, gt, mask, c_frac)
    raise ValueError(f"berhu_loss: no implementation for device {pred.device}")


def scale_invariant_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                         lam: float = 0.5) -> torch.Tensor:
    """Eigen et al. (2014) scale-invariant log loss:
    mean(d^2) - lam * mean(d)^2 with d = log(pred) - log(gt) over valid pixels."""
    m = mask.to(torch.float32)
    d = (pred.to(torch.float32).clamp(min=1e-6).log()
         - gt.to(torch.float32).clamp(min=1e-6).log()) * m
    sq, lin, count = global_sums((d * d).sum(), d.sum(), m.sum())
    count = count.clamp(min=1.0)
    return sq / count - lam * (lin / count) ** 2


def grouped_route(loss_fn: Callable, device_type: str) -> Callable | None:
    """The grouped entry ``(preds, gt, mask, weights) -> weighted total``
    that computes the multi-scale ``loss_fn`` on a device of
    ``device_type`` in one launch each way, or None for the per-scale loop.
    BerHu is the only supervised loss with a kernel, so only ``berhu_loss``
    on CUDA tensors is grouped; every other loss, the plain BerHu included,
    and the CPU run the loop."""
    return berhu_loss_many_cuda if loss_fn is berhu_loss and device_type == "cuda" else None


def multiscale_supervised_loss(
    preds: Sequence[torch.Tensor],
    gt: torch.Tensor,
    mask: torch.Tensor,
    loss_fn: Callable,
    weights: tuple[float, ...] = (1.0, 0.5, 0.25, 0.125),
) -> torch.Tensor:
    """Weighted sum of ``loss_fn`` over the scales; each (B, h, w) prediction
    is bilinearly upsampled to GT resolution first (the sparse GT cannot be
    downsampled without corrupting it). On the card, BerHu takes all scales
    in one grouped call (``grouped_route``)."""
    H, W = gt.shape[1], gt.shape[2]
    pairs = list(zip(preds, weights))
    grouped = grouped_route(loss_fn, gt.device.type)
    if grouped is not None and pairs:
        ups = [interpolate_bilinear(pred[:, None], H, W)[:, 0].contiguous() for pred, _ in pairs]
        return grouped(ups, gt, mask, [w for _, w in pairs])
    total = torch.zeros((), dtype=torch.float32, device=gt.device)
    for pred, w in pairs:
        pred_up = interpolate_bilinear(pred[:, None], H, W)[:, 0].contiguous()
        total = total + w * loss_fn(pred_up, gt, mask)
    return total
