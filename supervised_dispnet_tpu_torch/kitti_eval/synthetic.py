"""Synthetic KITTI trees, made from a seed, for the eval CLIs' tests and
smoke runs where no KITTI data is at hand.

``write_kitti_raw`` writes the raw layout
(``<date>/calib_{cam_to_cam,velo_to_cam}.txt``,
``<date>/<drive>/image_02/data/<frame>.png``,
``<date>/<drive>/velodyne_points/data/<frame>.bin``) and an Eigen-format list
of its frames; with ``oxts=True`` also ``<date>/<drive>/oxts/data/<frame>.txt``
GPS/IMU packets (a car driving at 8-12 m/s, every sixth frame at 0.5 m/s, below
the ETL's 2 m/s speed floor), and with ``static_frames=k`` a
``static_frames.txt`` naming k frames of each drive, as the ETL
(``data/prepare_train_data.py``) reads them. Those draws come from a generator
of their own, so the frames and scans stay those of a call without them.

Calibration is KITTI-like (focal length 721.5 px at 1242 px width, principal
point at the centre, the velodyne's x forward, y left, z up). Each scan's
points lie in front of the camera, 3-80 m deep, and project into the lower
65% of the frame, as the LiDAR covers the road scene there. The frames are a
smooth gradient plus noise, written with the Paeth row filter, the costliest
for the decoder.

``write_kitti_odometry`` writes the odometry layout that the pose eval CLI
reads (``sequences/<seq>/image_2/<frame>.png``, ``poses/<seq>.txt``): a
camera driving forward ~1 m a frame, its heading and height wandering, each
step drawn in the current camera frame, with KITTI's cam-to-world rows; with
``calib=True`` also the ``sequences/<seq>/calib.txt`` (``P0:`` .. ``P3:``
rows) that the ETL's odometry crawler reads.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from supervised_dispnet_tpu_torch.utils.image_io import write_png

DATE = "2011_09_26"
# velodyne -> camera axes: x_cam = -y_velo, y_cam = -z_velo, z_cam = x_velo
VELO_TO_CAM_R = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=float)


def write_oxts(oxts_dir: Path, rng: np.random.Generator, frames: int) -> None:
    """One KITTI oxts packet (30 fields: lat, lon, alt, roll, pitch, yaw, vn,
    ve, ...) a frame at 10 Hz: a car at 8-12 m/s with a slowly turning
    heading, every sixth frame at 0.5 m/s."""
    oxts_dir.mkdir(parents=True, exist_ok=True)
    lat, lon, yaw = 49.011, 8.423, rng.uniform(-np.pi, np.pi)
    for i in range(frames):
        speed = 0.5 if i % 6 == 5 else rng.uniform(8.0, 12.0)
        vn, ve = speed * np.cos(yaw), speed * np.sin(yaw)
        vals = [lat, lon, 112.0 + rng.normal(0, 0.05), rng.normal(0, 0.01),
                rng.normal(0, 0.01), yaw, vn, ve, speed, 0.0, 0.0] + [0.0] * 12 + [
                    0.1, 0.05, 4, 10, 5, 5, 6]
        (oxts_dir / f"{i:010d}.txt").write_text(" ".join(f"{v:.12g}" for v in vals) + "\n")
        lat += vn * 0.1 / 111_320.0
        lon += ve * 0.1 / (111_320.0 * np.cos(np.radians(lat)))
        yaw += rng.normal(0, 0.01)


def write_kitti_raw(root: str | Path, seed: int = 0, drives: int = 2, frames: int = 8,
                    height: int = 375, width: int = 1242,
                    points: int = 100_000, oxts: bool = False,
                    static_frames: int = 0) -> Path:
    """Write ``drives`` x ``frames`` frames of (height, width) RGB with one
    velodyne scan of ``points`` points each under ``root``; returns the path
    of the Eigen-format list of them (``root / "eigen_test_files.txt"``).
    ``oxts`` adds a GPS/IMU packet a frame, ``static_frames`` lists that many
    frames of each drive in ``root / "static_frames.txt"``."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    extra = np.random.default_rng([seed, 1])  # oxts and static frames
    date_dir = root / DATE
    date_dir.mkdir(parents=True, exist_ok=True)
    f = 721.5377 * width / 1242.0
    cx, cy = width / 2, height / 2
    P = np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0]])
    (date_dir / "calib_cam_to_cam.txt").write_text(
        "calib_time: 09-Jan-2012 13:57:47\n"
        f"R_rect_00: {' '.join(map(str, np.eye(3).ravel()))}\n"
        f"P_rect_02: {' '.join(map(str, P.ravel()))}\n")
    (date_dir / "calib_velo_to_cam.txt").write_text(
        f"R: {' '.join(map(str, VELO_TO_CAM_R.ravel()))}\nT: 0 0 0\n")

    yy, xx = np.mgrid[:height, :width]
    lines, static = [], []
    for d in range(1, drives + 1):
        drive = f"{DATE}_drive_{d:04d}_sync"
        img_dir = date_dir / drive / "image_02" / "data"
        velo_dir = date_dir / drive / "velodyne_points" / "data"
        img_dir.mkdir(parents=True, exist_ok=True)
        velo_dir.mkdir(parents=True, exist_ok=True)
        for i in range(frames):
            base = np.stack([xx * (255 / width), yy * (255 / height),
                             (xx + yy + 40 * i) % 256], axis=-1)
            img = np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)
            write_png(img_dir / f"{i:010d}.png", img, filter_type=4)
            z = rng.uniform(3.0, 80.0, points)
            u = rng.uniform(0, width, points)
            v = rng.uniform(0.35 * height, height, points)
            scan = np.stack([z, -(u - cx) * z / f, -(v - cy) * z / f,
                             rng.uniform(0, 1, points)], axis=1)
            scan.astype(np.float32).tofile(velo_dir / f"{i:010d}.bin")
            lines.append(f"{DATE}/{drive}/image_02/data/{i:010d}.png")
        if oxts:
            write_oxts(date_dir / drive / "oxts" / "data", extra, frames)
        static += [f"{DATE} {drive} {i:010d}"
                   for i in sorted(extra.choice(frames, static_frames, replace=False))]
    if static_frames:
        (root / "static_frames.txt").write_text("\n".join(static) + "\n")
    list_file = root / "eigen_test_files.txt"
    list_file.write_text("\n".join(lines) + "\n")
    return list_file


def _euler_mat(a: np.ndarray) -> np.ndarray:
    """Rx @ Ry @ Rz of Euler angles (x, y, z)."""
    (cx, cy, cz), (sx, sy, sz) = np.cos(a), np.sin(a)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rx @ ry @ rz


def write_kitti_odometry(root: str | Path, seed: int = 0, seq: str = "09",
                         frames: int = 40, height: int = 375, width: int = 1242,
                         rot: float = 0.02, calib: bool = False) -> Path:
    """Write one odometry sequence of ``frames`` (height, width) RGB PNGs and
    its ground-truth poses under ``root``; returns ``root``.

    Each step moves the camera in its own frame by ~1 m forward (z), up to
    0.1 m sideways and 0.05 m up or down, and turns it by up to ``rot`` rad
    about each axis. The poses file holds each frame's 3x4 camera-to-world
    matrix in frame 0's coordinates, one flattened row a frame. The images
    are a gradient that slides with the frame index, plus noise. ``calib``
    writes the sequence's ``calib.txt`` (KITTI's 718.856 px focal length at
    1241 px width, the principal point at the centre)."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    img_dir = root / "sequences" / seq / "image_2"
    img_dir.mkdir(parents=True, exist_ok=True)
    if calib:
        f = 718.856 * width / 1241.0
        P = np.array([[f, 0, width / 2, 0], [0, f, height / 2, 0], [0, 0, 1, 0]])
        (root / "sequences" / seq / "calib.txt").write_text("".join(
            f"P{c}: {' '.join(f'{v:.12e}' for v in P.ravel())}\n" for c in range(4)))
    (root / "poses").mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[:height, :width]
    R_wc, t_wc = np.eye(3), np.zeros(3)  # x_cam = R_wc @ x_0 + t_wc
    rows = []
    for i in range(frames):
        base = np.stack([(xx + 7 * i) * (255 / width) % 256, yy * (255 / height),
                         (xx + yy + 40 * i) % 256], axis=-1)
        img = np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)
        write_png(img_dir / f"{i:06d}.png", img, filter_type=4)
        R_cw = R_wc.T
        rows.append(np.concatenate([R_cw, (-R_cw @ t_wc)[:, None]], axis=1).ravel())
        step = _euler_mat(rng.uniform(-rot, rot, 3))
        dt = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.05, 0.05),
                       -rng.uniform(0.8, 1.2)])
        R_wc = step @ R_wc
        t_wc = step @ t_wc + dt
    np.savetxt(root / "poses" / f"{seq}.txt", np.stack(rows), fmt="%.9e")
    return root
