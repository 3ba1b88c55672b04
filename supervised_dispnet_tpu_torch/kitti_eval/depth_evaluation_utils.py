"""Eigen-split depth evaluation: velodyne GT projection, Garg crop,
depth caps, median scaling. The port's copy of
``supervised_dispnet_tpu/kitti_eval/depth_evaluation_utils.py`` (pure
numpy, as there): the projection takes the numpy path only, and the frames
are read with the port's own codec (``utils/image_io.py::read_image``).

Rebuild of the reference harness (reference:
``kitti_eval/depth_evaluation_utils.py::{test_framework_KITTI,
read_scene_data, generate_depth_map, compute_errors}``).

Protocol (standard Eigen eval):
- GT depth = raw velodyne points projected through calib into image 2,
  z-buffered (min depth wins on collisions).
- Valid mask = Garg crop ∧ (min_depth < gt < max_depth); caps 80 m
  (50 m variant supported).
- Self-supervised predictions are median-scaled per image
  (scale = median(gt) / median(pred)); supervised ones are not.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from supervised_dispnet_tpu_torch.utils.image_io import read_image

# Garg ECCV16 crop, fractions of (H, W)
GARG_CROP = (0.40810811, 0.99189189, 0.03594771, 0.96405229)


def read_calib_file(path: str | Path) -> dict[str, np.ndarray]:
    """Parse a KITTI calib txt into name -> float array."""
    data: dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            try:
                data[key.strip()] = np.asarray(
                    [float(x) for x in value.split()], dtype=np.float64
                )
            except ValueError:
                pass  # non-numeric entries (e.g. calib_time)
    return data


def load_velodyne_points(path: str | Path) -> np.ndarray:
    """Raw velodyne scan -> (N, 4) homogeneous points (reflectance -> 1)."""
    points = np.fromfile(str(path), dtype=np.float32).reshape(-1, 4)
    points[:, 3] = 1.0
    return points


def velo2cam_matrix(calib_dir: str | Path, cam: int = 2) -> np.ndarray:
    """(3, 4) projection from velodyne frame to image plane of ``cam``."""
    calib_dir = Path(calib_dir)
    cam2cam = read_calib_file(calib_dir / "calib_cam_to_cam.txt")
    velo2cam = read_calib_file(calib_dir / "calib_velo_to_cam.txt")
    T_velo2cam = np.vstack(
        [
            np.hstack([velo2cam["R"].reshape(3, 3), velo2cam["T"].reshape(3, 1)]),
            np.array([0, 0, 0, 1.0]),
        ]
    )
    R_rect = np.eye(4)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    return P_rect @ R_rect @ T_velo2cam


def generate_depth_map(
    calib_dir: str | Path,
    velo_file: str | Path,
    im_shape: tuple[int, int],
    cam: int = 2,
) -> np.ndarray:
    """Project a velodyne scan into a sparse (H, W) depth map.

    The numpy projection of the JAX package's ``generate_depth_map``, its
    semantic reference (the C++ projector there is an optional speed-up).
    (reference: ``kitti_eval/depth_evaluation_utils.py::generate_depth_map``)
    """
    H, W = im_shape
    P = velo2cam_matrix(calib_dir, cam)
    velo = load_velodyne_points(velo_file)
    velo = velo[velo[:, 0] >= 1e-3]  # points in front of the sensor

    pts = (P @ velo.T).T  # (N, 3)
    z = pts[:, 2]
    u = pts[:, 0] / z
    v = pts[:, 1] / z

    # KITTI convention: round to nearest pixel, 1-indexed in the devkit;
    # use 0-indexed rounding here
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    ok = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (z > 0)
    ui, vi, z = ui[ok], vi[ok], z[ok]

    depth = np.zeros((H, W), dtype=np.float32)
    # z-buffer: nearest point wins on duplicate pixels
    order = np.argsort(-z)  # write far first, near last overwrites
    depth[vi[order], ui[order]] = z[order]
    return depth


def garg_crop_mask(h: int, w: int) -> np.ndarray:
    """Boolean (h, w) Garg crop mask."""
    y1, y2 = int(GARG_CROP[0] * h), int(GARG_CROP[1] * h)
    x1, x2 = int(GARG_CROP[2] * w), int(GARG_CROP[3] * w)
    m = np.zeros((h, w), dtype=bool)
    m[y1:y2, x1:x2] = True
    return m


def compute_errors(gt: np.ndarray, pred: np.ndarray) -> dict[str, float]:
    """Eigen error suite over flat valid arrays (numpy)."""
    thresh = np.maximum(gt / pred, pred / gt)
    d = gt - pred
    dlog = np.log(gt) - np.log(pred)
    return {
        "abs_rel": float(np.mean(np.abs(d) / gt)),
        "sq_rel": float(np.mean(d**2 / gt)),
        "rmse": float(np.sqrt(np.mean(d**2))),
        "rmse_log": float(np.sqrt(np.mean(dlog**2))),
        "a1": float(np.mean(thresh < 1.25)),
        "a2": float(np.mean(thresh < 1.25**2)),
        "a3": float(np.mean(thresh < 1.25**3)),
    }


@dataclasses.dataclass
class EvalConfig:
    min_depth: float = 1e-3
    max_depth: float = 80.0
    use_garg_crop: bool = True
    median_scaling: bool = False  # True for self-supervised models


def evaluate_depth(
    gt_depths: list[np.ndarray],
    pred_depths: list[np.ndarray],
    config: EvalConfig = EvalConfig(),
) -> dict[str, float]:
    """Aggregate Eigen metrics over a test set.

    Each pred is resized-to-GT by the caller; this function applies crop,
    caps, optional median scaling, and averages per-image errors
    (reference: the accumulation loop in ``test_disp.py::main``).
    """
    accum: dict[str, float] = {}
    n = 0
    scales = []
    for gt, pred in zip(gt_depths, pred_depths):
        assert gt.shape == pred.shape, (gt.shape, pred.shape)
        h, w = gt.shape
        valid = (gt > config.min_depth) & (gt < config.max_depth)
        if config.use_garg_crop:
            valid &= garg_crop_mask(h, w)
        if valid.sum() == 0:
            continue
        g = gt[valid]
        p = pred[valid]
        if config.median_scaling:
            scale = np.median(g) / max(np.median(p), 1e-8)
            scales.append(scale)
            p = p * scale
        p = np.clip(p, config.min_depth, config.max_depth)
        errs = compute_errors(g, p)
        for k, v in errs.items():
            accum[k] = accum.get(k, 0.0) + v
        n += 1
    out = {k: v / max(n, 1) for k, v in accum.items()}
    out["n_images"] = float(n)
    if scales:
        out["median_scale_mean"] = float(np.mean(scales))
    return out


class KittiEigenFramework:
    """Iterates the Eigen test files, yielding image paths + GT depth.

    (reference: ``kitti_eval/depth_evaluation_utils.py::test_framework_KITTI``)

    ``test_list`` lines use the canonical format
    ``<date>/<drive>/image_02/data/<frame>.png`` (one path per line,
    relative to the KITTI raw root).
    """

    def __init__(
        self,
        root: str | Path,
        test_files: list[str],
        min_depth: float = 1e-3,
        max_depth: float = 80.0,
    ):
        self.root = Path(root)
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.samples = [t.strip() for t in test_files if t.strip()]

    def __len__(self) -> int:
        return len(self.samples)

    def __iter__(self):
        for rel in self.samples:
            rel_path = Path(rel)
            img_path = self.root / rel_path
            date = rel_path.parts[0]
            drive = rel_path.parts[1]
            frame = rel_path.stem
            velo = (
                self.root / date / drive / "velodyne_points" / "data" / f"{frame}.bin"
            )
            img = read_image(img_path)
            gt = generate_depth_map(self.root / date, velo, img.shape[:2])
            yield {
                "img": img,
                "gt_depth": gt,
                "path": str(img_path),
            }
