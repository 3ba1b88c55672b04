"""Depth evaluation metrics: the masked Eigen-split error suite, the port of
``supervised_dispnet_tpu/losses/metrics.py``. On a data-parallel mesh
(``parallel/mesh.py``) the masked means are the global batch's."""

from __future__ import annotations

import torch

from supervised_dispnet_tpu_torch.parallel.mesh import global_sums


def compute_errors(gt: torch.Tensor, pred: torch.Tensor,
                   mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """abs_diff, abs_rel, sq_rel, rmse, rmse_log, a1 (delta < 1.25), a2, a3 as
    masked means over same-shape depth tensors; 0-d tensors on gt's device."""
    gt = gt.to(torch.float32)
    pred = pred.to(torch.float32)
    m = torch.ones_like(gt) if mask is None else mask.to(torch.float32)
    safe_gt = gt.clamp(min=1e-6)
    safe_pred = pred.clamp(min=1e-6)
    thresh = torch.maximum(safe_gt / safe_pred, safe_pred / safe_gt)
    diff = gt - pred
    dlog = safe_gt.log() - safe_pred.log()
    terms = {
        "abs_diff": diff.abs(),
        "abs_rel": diff.abs() / safe_gt,
        "sq_rel": diff * diff / safe_gt,
        "rmse": diff * diff,
        "rmse_log": dlog * dlog,
        "a1": (thresh < 1.25).to(torch.float32),
        "a2": (thresh < 1.25 ** 2).to(torch.float32),
        "a3": (thresh < 1.25 ** 3).to(torch.float32),
    }
    *sums, count = global_sums(*((x * m).sum() for x in terms.values()), m.sum())
    count = count.clamp(min=1.0)
    out = {k: s / count for k, s in zip(terms, sums)}
    out["rmse"], out["rmse_log"] = out["rmse"].sqrt(), out["rmse_log"].sqrt()
    return out
