"""Depth evaluation metrics: the masked Eigen-split error suite, the port of
``supervised_dispnet_tpu/losses/metrics.py``."""

from __future__ import annotations

import torch


def compute_errors(gt: torch.Tensor, pred: torch.Tensor,
                   mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """abs_diff, abs_rel, sq_rel, rmse, rmse_log, a1 (delta < 1.25), a2, a3 as
    masked means over same-shape depth tensors; 0-d tensors on gt's device."""
    gt = gt.to(torch.float32)
    pred = pred.to(torch.float32)
    m = torch.ones_like(gt) if mask is None else mask.to(torch.float32)
    count = m.sum().clamp(min=1.0)

    def mmean(x: torch.Tensor) -> torch.Tensor:
        return (x * m).sum() / count

    safe_gt = gt.clamp(min=1e-6)
    safe_pred = pred.clamp(min=1e-6)
    thresh = torch.maximum(safe_gt / safe_pred, safe_pred / safe_gt)
    diff = gt - pred
    dlog = safe_gt.log() - safe_pred.log()
    return {
        "abs_diff": mmean(diff.abs()),
        "abs_rel": mmean(diff.abs() / safe_gt),
        "sq_rel": mmean(diff * diff / safe_gt),
        "rmse": mmean(diff * diff).sqrt(),
        "rmse_log": mmean(dlog * dlog).sqrt(),
        "a1": mmean((thresh < 1.25).to(torch.float32)),
        "a2": mmean((thresh < 1.25 ** 2).to(torch.float32)),
        "a3": mmean((thresh < 1.25 ** 3).to(torch.float32)),
    }
