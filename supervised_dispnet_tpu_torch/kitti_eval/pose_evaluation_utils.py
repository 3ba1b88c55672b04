"""Odometry pose evaluation: snippet ATE / RE. A copy of
``supervised_dispnet_tpu/kitti_eval/pose_evaluation_utils.py`` (numpy
only; reference: ``kitti_eval/pose_evaluation_utils.py``, used by
``test_pose.py`` on KITTI odometry sequences 09/10): per-snippet alignment
to the first frame, optimal scale fit, then the translation error (ATE,
the reference's ``||err||_F / N``) and the rotation error (RE).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_odometry_poses(pose_file: str | Path) -> np.ndarray:
    """KITTI odometry ground-truth file -> (N, 3, 4) cam-to-world poses."""
    data = np.loadtxt(str(pose_file))
    return data.reshape(-1, 3, 4)


def snippet_from_poses(
    poses: np.ndarray, indices: np.ndarray, relative_to: str = "first"
) -> np.ndarray:
    """Extract a snippet of absolute poses re-expressed relative to one of
    its frames ('first' per the reference protocol, or 'mid'):
    (len(indices), 3, 4)."""
    anchor_idx = indices[0] if relative_to == "first" else indices[len(indices) // 2]
    anchor = poses[anchor_idx]
    R_a = anchor[:, :3]
    t_a = anchor[:, 3]
    snippet = []
    for i in indices:
        R = poses[i][:, :3]
        t = poses[i][:, 3]
        R_rel = R_a.T @ R
        t_rel = R_a.T @ (t - t_a)
        snippet.append(np.hstack([R_rel, t_rel[:, None]]))
    return np.stack(snippet)


def compute_ate(gt: np.ndarray, pred: np.ndarray) -> float:
    """Absolute trajectory error of one snippet after first-frame alignment
    and optimal scale (reference: ``pose_evaluation_utils.py::compute_ate``)."""
    gt_xyz = gt[:, :, 3]
    pred_xyz = pred[:, :, 3]
    offset = gt_xyz[0] - pred_xyz[0]
    pred_xyz = pred_xyz + offset
    # optimal least-squares scale
    denom = float(np.sum(pred_xyz**2))
    scale = float(np.sum(gt_xyz * pred_xyz)) / denom if denom > 1e-12 else 1.0
    err = gt_xyz - scale * pred_xyz
    # Reference protocol (SfmLearner lineage): ||err||_F / snippet_length,
    # i.e. sqrt(sum of squared per-axis errors) / N — NOT an RMSE. An RMSE
    # form would be sqrt(N)x larger and incomparable to published tables.
    return float(np.sqrt(np.sum(err**2)) / gt.shape[0])


def compute_re(gt: np.ndarray, pred: np.ndarray) -> float:
    """Mean rotation angle error (radians) over a snippet."""
    errs = []
    for g, p in zip(gt, pred):
        dR = g[:, :3] @ p[:, :3].T
        cos = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
        errs.append(np.arccos(cos))
    return float(np.mean(errs))


def evaluate_pose_snippets(
    gt_snippets: list[np.ndarray], pred_snippets: list[np.ndarray]
) -> dict[str, float]:
    """Aggregate ATE/RE (mean and std) over all snippets."""
    ates = [compute_ate(g, p) for g, p in zip(gt_snippets, pred_snippets)]
    res = [compute_re(g, p) for g, p in zip(gt_snippets, pred_snippets)]
    return {
        "ate_mean": float(np.mean(ates)),
        "ate_std": float(np.std(ates)),
        "re_mean": float(np.mean(res)),
        "re_std": float(np.std(res)),
        "n_snippets": float(len(ates)),
    }
