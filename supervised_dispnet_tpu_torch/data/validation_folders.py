"""Validation frames with GT depth read from a dump tree: the port's copy of
``supervised_dispnet_tpu/data/validation_folders.py`` (reference:
``datasets/validation_folders.py::ValidationSet``): every frame of the
``val.txt`` scenes that has a same-stem ``.npy`` depth dump."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from supervised_dispnet_tpu_torch.data.sequence_folders import (
    collate, load_as_float, load_as_uint8, read_scenes, scene_frames)


class ValidationSet:
    def __init__(self, root: str | Path, uint8: bool = False):
        self.uint8 = uint8
        self.root = Path(root)
        self.samples = []
        for scene in read_scenes(self.root, "val"):
            for img in scene_frames(scene):
                depth = img.with_suffix(".npy")
                if depth.exists():
                    self.samples.append((img, depth))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> dict:
        img_path, depth_path = self.samples[index]
        img = load_as_uint8(img_path) if self.uint8 else load_as_float(img_path) / 255.0
        return {"img": img, "depth": np.load(depth_path).astype(np.float32)}

    def get_batch(self, ids) -> dict[str, np.ndarray]:
        """The samples ``ids``, stacked (used by ``BatchLoader``)."""
        return collate([self[int(i)] for i in ids])
