"""KITTI raw ETL crawler: the port's copy of
``supervised_dispnet_tpu/data/kitti_raw_loader.py`` (reference:
``data/kitti_raw_loader.py::KittiRawLoader``). Crawls KITTI raw drives,
excludes static frames (``static_frames.txt``) and Eigen test scenes,
rescales images to the dump resolution with matching intrinsics rescale,
and optionally projects velodyne scans to sparse GT depth and oxts to GT
poses at the dump resolution. Frames are decoded with the port's codec
(``utils/image_io.py::read_image``) and resized as ``cv2.INTER_AREA`` does
(``data/image_resize.py::resize_area_uint8``); depth is projected with the
port's numpy ``generate_depth_map``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from supervised_dispnet_tpu_torch.data.image_resize import resize_area_uint8
from supervised_dispnet_tpu_torch.kitti_eval.depth_evaluation_utils import (
    generate_depth_map, read_calib_file)
from supervised_dispnet_tpu_torch.utils.image_io import read_image

CAMERAS = {"l": 2, "r": 3}


def read_static_frames(path: str | Path) -> set[tuple[str, str]]:
    """static_frames.txt lines: ``<date> <drive> <frame_id>`` -> excluded
    (drive, frame) pairs."""
    out = set()
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                drive, frame = parts[1], parts[2]
                out.add((drive, f"{int(frame):010d}"))
    return out


def oxts_to_pose(oxts_files: list[Path]) -> np.ndarray:
    """GPS/IMU oxts packets -> (N, 3, 4) poses relative to the first frame
    (mercator projection, reference: ``data/kitti_raw_loader.py`` pose dump)."""
    er = 6378137.0  # earth radius
    poses = []
    scale = None
    origin = None
    for f in oxts_files:
        vals = np.genfromtxt(f)
        lat, lon, alt = vals[0], vals[1], vals[2]
        roll, pitch, yaw = vals[3], vals[4], vals[5]
        if scale is None:
            scale = np.cos(lat * np.pi / 180.0)
        tx = scale * lon * np.pi * er / 180.0
        ty = er * scale * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
        tz = alt
        t = np.array([tx, ty, tz])

        def rot(axis, a):
            c, s = np.cos(a), np.sin(a)
            if axis == "x":
                return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
            if axis == "y":
                return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

        R = rot("z", yaw) @ rot("y", pitch) @ rot("x", roll)
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        if origin is None:
            origin = np.linalg.inv(T)
        poses.append((origin @ T)[:3])
    return np.stack(poses)


class KittiRawLoader:
    def __init__(
        self,
        dataset_dir: str | Path,
        static_frames_file: str | Path | None = None,
        img_height: int = 128,
        img_width: int = 416,
        min_speed: float = 2.0,
        get_depth: bool = False,
        get_pose: bool = False,
        test_scene_file: str | Path | None = None,
        cameras: tuple[str, ...] = ("l",),
    ):
        self.dataset_dir = Path(dataset_dir)
        self.img_height = img_height
        self.img_width = img_width
        self.min_speed = min_speed
        self.get_depth = get_depth
        self.get_pose = get_pose
        self.cameras = cameras

        self.static_frames = (
            read_static_frames(static_frames_file) if static_frames_file else set()
        )
        test_scenes = set()
        if test_scene_file:
            # one drive name per line, e.g. 2011_09_26_drive_0002_sync
            with open(test_scene_file) as f:
                test_scenes = {line.strip() for line in f if line.strip()}
        self.scenes = []
        for date_dir in sorted(self.dataset_dir.iterdir()):
            if not date_dir.is_dir() or not date_dir.name.startswith("2011"):
                continue
            for drive in sorted(date_dir.iterdir()):
                if drive.is_dir() and drive.name.endswith("_sync"):
                    if drive.name not in test_scenes:
                        self.scenes.append(drive)

    def collect_scene_data(self, drive: Path):
        """Yield one dict per camera with frames, intrinsics, and GT."""
        date_dir = drive.parent
        cam2cam = read_calib_file(date_dir / "calib_cam_to_cam.txt")
        for cam_name in self.cameras:
            cam = CAMERAS[cam_name]
            img_dir = drive / f"image_{cam:02d}" / "data"
            if not img_dir.exists():
                continue
            frames = sorted(img_dir.glob("*.png")) or sorted(img_dir.glob("*.jpg"))
            frames = [
                f
                for f in frames
                if (drive.name, f.stem) not in self.static_frames
            ]
            # GPS-speed fallback when no static_frames list was given
            # (reference: the ETL's min-speed exclusion of stationary frames)
            if not self.static_frames and self.min_speed > 0:
                oxts_dir = drive / "oxts" / "data"
                if oxts_dir.exists():
                    frames = [
                        f for f in frames
                        if self._frame_speed(oxts_dir / f"{f.stem}.txt")
                        >= self.min_speed
                    ]
            if not frames:
                continue
            P = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
            intrinsics = P[:, :3].astype(np.float32)
            scene = {
                "name": f"{drive.name}_{cam:02d}",
                "date_dir": date_dir,
                "drive": drive,
                "cam": cam,
                "frames": frames,
                "intrinsics": intrinsics,
            }
            if self.get_pose:
                # pose rows must align 1:1 with the (filtered) frames — use
                # each kept frame's matching oxts packet, not the raw listing
                oxts_dir = drive / "oxts" / "data"
                oxts = [oxts_dir / f"{f.stem}.txt" for f in frames]
                if all(o.exists() for o in oxts) and oxts:
                    scene["poses"] = oxts_to_pose(oxts)
            yield scene

    @staticmethod
    def _frame_speed(oxts_file: Path) -> float:
        """Ground speed (m/s) from an oxts packet (vn, ve = fields 6, 7)."""
        try:
            vals = np.genfromtxt(oxts_file)
            return float(np.hypot(vals[6], vals[7]))
        except Exception:
            return float("inf")  # unknown -> keep the frame

    def load_image(self, scene: dict, i: int):
        """Decode + resize a frame; returns (img_u8, zoomed intrinsics, raw
        (h, w))."""
        img = read_image(scene["frames"][i])
        h, w = img.shape[:2]
        zx = self.img_width / w
        zy = self.img_height / h
        out = resize_area_uint8(img, self.img_height, self.img_width)
        K = scene["intrinsics"].copy()
        K[0] *= zx
        K[1] *= zy
        return out, K, (h, w)

    def get_depth_map(self, scene: dict, i: int) -> np.ndarray:
        """Sparse GT depth at dump resolution for frame i (nearest-bin
        reprojection of the velodyne scan directly at the low resolution —
        avoids decimating a high-res sparse map)."""
        frame = scene["frames"][i].stem
        velo = scene["drive"] / "velodyne_points" / "data" / f"{frame}.bin"
        # raw resolution is constant per scene: decode once, cache on the
        # scene dict (load_image decodes frames anyway — no second decode)
        if "raw_shape" not in scene:
            scene["raw_shape"] = read_image(scene["frames"][i]).shape[:2]
        h, w = scene["raw_shape"]
        depth_full = generate_depth_map(scene["date_dir"], velo, (h, w), cam=scene["cam"])
        # sparse-aware decimation: take max-depth... use nearest valid in each cell
        zy, zx = h / self.img_height, w / self.img_width
        ys, xs = np.nonzero(depth_full)
        d = depth_full[ys, xs]
        yi = np.clip((ys / zy).astype(np.int64), 0, self.img_height - 1)
        xi = np.clip((xs / zx).astype(np.int64), 0, self.img_width - 1)
        out = np.zeros((self.img_height, self.img_width), dtype=np.float32)
        order = np.argsort(-d)  # nearest point wins
        out[yi[order], xi[order]] = d[order]
        return out
