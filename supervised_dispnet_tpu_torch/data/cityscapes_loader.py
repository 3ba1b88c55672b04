"""Cityscapes ETL crawler (the reference's secondary training dataset): the
port's copy of ``supervised_dispnet_tpu/data/cityscapes_loader.py``. Rebuild of the reference loader (reference: ``data/cityscapes_loader.py``):
crawls leftImg8bit sequence frames, reads per-city camera intrinsics from
the ``camera/`` json dumps, crops the ego-vehicle hood (bottom 25%), and
resizes to the dump resolution with matching intrinsics rescale. Used
through ``prepare_train_data`` with ``--dataset-format cityscapes``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from supervised_dispnet_tpu_torch.data.image_resize import resize_area_uint8
from supervised_dispnet_tpu_torch.utils.image_io import read_image


class CityscapesLoader:
    def __init__(
        self,
        dataset_dir: str | Path,
        split: str = "train",
        img_height: int = 128,
        img_width: int = 416,
        crop_bottom: float = 0.75,  # keep top 75%, drop the hood
    ):
        self.dataset_dir = Path(dataset_dir)
        self.img_height = img_height
        self.img_width = img_width
        self.crop_bottom = crop_bottom
        self.get_depth = False  # no LiDAR GT in cityscapes sequences
        self.get_pose = False
        img_root = self.dataset_dir / "leftImg8bit_sequence" / split
        if not img_root.exists():
            img_root = self.dataset_dir / "leftImg8bit" / split
        self.img_root = img_root
        self.cam_root = self.dataset_dir / "camera" / split
        self.scenes = sorted(p for p in img_root.iterdir() if p.is_dir()) if img_root.exists() else []

    def _intrinsics_for(self, city: str, frame_stem: str) -> np.ndarray | None:
        """Read fx, fy, u0, v0 from the matching camera json."""
        cam_dir = self.cam_root / city
        if not cam_dir.exists():
            return None
        cand = cam_dir / (frame_stem.replace("leftImg8bit", "camera") + ".json")
        if not cand.exists():
            jsons = sorted(cam_dir.glob("*.json"))
            if not jsons:
                return None
            cand = jsons[0]
        data = json.loads(cand.read_text())
        intr = data.get("intrinsic", data)
        return np.array(
            [[intr["fx"], 0, intr["u0"]],
             [0, intr["fy"], intr["v0"]],
             [0, 0, 1]], dtype=np.float32)

    def collect_scene_data(self):
        """Yield per-(city, sequence) scenes of consecutive frames."""
        for city_dir in self.scenes:
            frames = sorted(city_dir.glob("*leftImg8bit.png"))
            # group by sequence id: <city>_<seq>_<frame>_leftImg8bit.png
            groups: dict[str, list[Path]] = {}
            for f in frames:
                parts = f.stem.split("_")
                seq = "_".join(parts[:2]) if len(parts) >= 4 else f.stem
                groups.setdefault(seq, []).append(f)
            for seq, fs in sorted(groups.items()):
                K = self._intrinsics_for(city_dir.name, fs[0].stem)
                if K is None:
                    continue
                yield {
                    "name": f"cityscapes_{seq}",
                    "frames": fs,
                    "intrinsics": K,
                }

    def load_image(self, scene: dict, i: int):
        img = read_image(scene["frames"][i])
        h, w = img.shape[:2]
        hc = int(h * self.crop_bottom)
        zx = self.img_width / w
        zy = self.img_height / hc
        out = resize_area_uint8(img[:hc], self.img_height, self.img_width)
        K = scene["intrinsics"].copy()
        K[0] *= zx
        K[1] *= zy
        return out, K, (h, w)
