"""Training snippets read from a dump tree's frames: the port's copy of
``supervised_dispnet_tpu/data/sequence_folders.py`` (reference:
``datasets/sequence_folders.py::SequenceFolder``), decoding with the port's
own codec (``utils/image_io.py::read_image``). Directory layout, as
``data/prepare_train_data.py`` writes it:

    root/
      train.txt            # scene dir names, one per line
      val.txt
      <scene>/
        0000000000.jpg     # frames, lexicographically ordered
        ...
        cam.txt            # 3x3 intrinsics (9 floats)
        0000000000.npy     # optional GT depth dumps (--with-depth)
        poses.txt          # optional GT poses (--with-pose)

Each sample: target frame + (seq_len - 1) neighbours at +-demi_length,
shared intrinsics, optional target GT depth. ``get_batch`` stacks the
samples of a batch for ``data/loader.py::BatchLoader``.
"""

from __future__ import annotations

import random
from pathlib import Path

import numpy as np

from supervised_dispnet_tpu_torch.utils.image_io import read_image

FRAME_SUFFIXES = (".jpg", ".png")


def load_as_uint8(path: Path) -> np.ndarray:
    """Decode a frame to (H, W, 3) uint8 RGB."""
    return read_image(path)


def load_as_float(path: Path) -> np.ndarray:
    """Decode a frame to (H, W, 3) float32 RGB in [0, 255]."""
    return load_as_uint8(path).astype(np.float32)


def scene_frames(scene: Path) -> list[Path]:
    """A scene's frames, sorted by name."""
    return sorted(p for p in scene.iterdir() if p.suffix.lower() in FRAME_SUFFIXES)


def read_scenes(root: Path, split: str) -> list[Path]:
    """The scene directories that ``<split>.txt`` names."""
    with open(root / f"{split}.txt") as f:
        return [root / line.strip() for line in f if line.strip()]


def read_intrinsics(scene: Path) -> np.ndarray:
    """(3, 3) float32 of a scene's ``cam.txt``."""
    return np.genfromtxt(scene / "cam.txt").astype(np.float32).reshape(3, 3)


def collate(items: list[dict]) -> dict[str, np.ndarray]:
    """Stack a batch's samples key by key."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class SequenceFolder:
    def __init__(self, root: str | Path, seed: int | None = None, train: bool = True,
                 sequence_length: int = 3, with_depth: bool = False, shuffle: bool = True,
                 uint8: bool = False):
        """``uint8=True`` yields raw uint8 images (the train step converts to
        float on the card)."""
        self.root = Path(root)
        self.with_depth = with_depth
        self.uint8 = uint8
        scenes = read_scenes(self.root, "train" if train else "val")
        self.samples = self._crawl(scenes, sequence_length)
        if shuffle:
            random.Random(seed).shuffle(self.samples)

    def _crawl(self, scenes: list[Path], sequence_length: int) -> list[dict]:
        samples = []
        demi = (sequence_length - 1) // 2
        for scene in scenes:
            intrinsics = read_intrinsics(scene)
            imgs = scene_frames(scene)
            if len(imgs) < sequence_length:
                continue
            for i in range(demi, len(imgs) - demi):
                refs = [imgs[i + j] for j in range(-demi, demi + 1) if j != 0]
                sample = {"intrinsics": intrinsics, "tgt": imgs[i], "ref_imgs": refs}
                if self.with_depth:
                    d = imgs[i].with_suffix(".npy")
                    if not d.exists():
                        continue
                    sample["depth"] = d
                samples.append(sample)
        return samples

    def __len__(self) -> int:
        return len(self.samples)

    def _load(self, path: Path) -> np.ndarray:
        return load_as_uint8(path) if self.uint8 else load_as_float(path) / 255.0

    def __getitem__(self, index: int) -> dict:
        s = self.samples[index]
        tgt = self._load(s["tgt"])
        refs = [self._load(p) for p in s["ref_imgs"]]
        out = {
            "tgt": tgt,  # (H, W, 3) float [0, 1] or uint8
            "ref_imgs": (np.stack(refs) if refs
                         else np.zeros((0,) + tgt.shape, np.uint8 if self.uint8 else np.float32)),
            "intrinsics": s["intrinsics"].copy(),
        }
        if self.with_depth:
            out["depth"] = np.load(s["depth"]).astype(np.float32)
        return out

    def get_batch(self, ids) -> dict[str, np.ndarray]:
        """The samples ``ids``, stacked (used by ``BatchLoader``)."""
        return collate([self[int(i)] for i in ids])
