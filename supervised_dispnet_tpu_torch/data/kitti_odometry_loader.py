"""KITTI odometry ETL crawler: the port's copy of
``supervised_dispnet_tpu/data/kitti_odometry_loader.py``. Rebuild of the reference's odometry dataset format (reference:
``data/prepare_train_data.py`` ``--dataset-format`` choices; the lineage
prepares odometry sequences 00-21 for pose training/eval). Layout:

    <root>/sequences/<seq>/image_2/*.png   (left color camera)
    <root>/sequences/<seq>/calib.txt       (P0..P3 projection rows)
    <root>/poses/<seq>.txt                 (GT cam0 poses, seqs 00-10)

Same interface as ``KittiRawLoader`` so ``prepare_train_data.dump_scene``
drives both: ``scenes`` / ``collect_scene_data`` / ``load_image``
(+ optional poses). Odometry has no velodyne-per-frame GT depth dump here;
it feeds self-supervised snippet training and pose evaluation.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from supervised_dispnet_tpu_torch.data.image_resize import resize_area_uint8
from supervised_dispnet_tpu_torch.utils.image_io import read_image

# sequences 09/10 are the reference's pose-eval split (test_pose.py)
DEFAULT_TEST_SEQUENCES = ("09", "10")


def read_odometry_calib(path: str | Path, cam: int = 2) -> np.ndarray:
    """calib.txt ``P{n}: <12 floats>`` rows -> (3, 3) intrinsics of cam."""
    with open(path) as f:
        for line in f:
            if line.startswith(f"P{cam}:"):
                P = np.array([float(v) for v in line.split()[1:]], np.float32).reshape(3, 4)
                return P[:, :3]
    raise ValueError(f"no P{cam} row in {path}")


class KittiOdometryLoader:
    def __init__(
        self,
        dataset_dir: str | Path,
        img_height: int = 128,
        img_width: int = 416,
        get_depth: bool = False,  # odometry format has no dumped GT depth
        get_pose: bool = True,
        test_sequences: tuple[str, ...] = DEFAULT_TEST_SEQUENCES,
        cam: int = 2,
    ):
        if get_depth:
            raise ValueError(
                "--with-depth is not available for the odometry format "
                "(no per-frame velodyne GT in the odometry layout)"
            )
        self.dataset_dir = Path(dataset_dir)
        self.img_height = img_height
        self.img_width = img_width
        self.get_depth = False
        self.get_pose = get_pose
        self.cam = cam
        seq_root = self.dataset_dir / "sequences"
        if not seq_root.exists():
            raise FileNotFoundError(f"no sequences/ under {self.dataset_dir}")
        self.scenes = [
            d for d in sorted(seq_root.iterdir())
            if d.is_dir() and d.name not in test_sequences
        ]

    def collect_scene_data(self, seq_dir: Path):
        img_dir = seq_dir / f"image_{self.cam}"
        if not img_dir.exists():
            return
        frames = sorted(img_dir.glob("*.png")) or sorted(img_dir.glob("*.jpg"))
        if not frames:
            return
        intrinsics = read_odometry_calib(seq_dir / "calib.txt", self.cam)
        scene = {
            "name": f"seq_{seq_dir.name}",
            "drive": seq_dir,
            "cam": self.cam,
            "frames": frames,
            "intrinsics": intrinsics,
        }
        if self.get_pose:
            pose_file = self.dataset_dir / "poses" / f"{seq_dir.name}.txt"
            if pose_file.exists():
                poses = np.loadtxt(pose_file).reshape(-1, 3, 4)
                if len(poses) == len(frames):
                    scene["poses"] = poses.astype(np.float32)
        yield scene

    def load_image(self, scene: dict, i: int):
        """Decode + resize a frame; returns (img_u8, zoomed K, raw shape)."""
        img = read_image(scene["frames"][i])
        h, w = img.shape[:2]
        out = resize_area_uint8(img, self.img_height, self.img_width)
        K = scene["intrinsics"].copy()
        K[0] *= self.img_width / w
        K[1] *= self.img_height / h
        return out, K, (h, w)
