"""Packed binary dataset readers (the port's own copy of the readers in
``supervised_dispnet_tpu/data/packed.py``), plus ``write_split``.

A packed split is raw numpy memmaps, so a batch is one fancy-index gather
from the page cache and the host needs no image decoder. Layout (one
directory per split):

    packed_root/<split>/
      images.u8        (n_frames, H, W, 3) uint8, C-order raw
      depth.f32        (n_frames, H, W) float32 (only if any GT depth dumped)
      intrinsics.f32   (n_scenes, 3, 3) float32
      meta.json        shapes + scene bounds + per-frame depth mask

Packing a JPEG dump tree (``pack_split``) stays with the JAX package's tools
for now; ``write_split`` writes a split from arrays already in memory.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np

META_NAME = "meta.json"


def write_split(out_dir: str | Path, images: np.ndarray, intrinsics: np.ndarray,
                scene_bounds: list[tuple[int, int]],
                depth: np.ndarray | None = None) -> dict:
    """Write one packed split: ``images`` (n, H, W, 3) uint8, ``intrinsics``
    (n_scenes, 3, 3), ``scene_bounds`` [(start, stop)] frame ranges per
    scene, optional ``depth`` (n, H, W) with zeros where GT is missing (a
    frame has GT when any of its depth is nonzero). Returns the meta dict."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n, H, W, _ = images.shape
    np.ascontiguousarray(images, np.uint8).tofile(out_dir / "images.u8")
    has_depth = np.zeros(n, bool)
    if depth is not None:
        np.ascontiguousarray(depth, np.float32).tofile(out_dir / "depth.f32")
        has_depth = (depth.reshape(n, -1) != 0).any(axis=1)
    np.ascontiguousarray(intrinsics, np.float32).tofile(out_dir / "intrinsics.f32")
    meta = {
        "height": int(H), "width": int(W), "n_frames": int(n),
        "n_scenes": len(scene_bounds),
        "scene_bounds": [list(b) for b in scene_bounds],
        "has_depth": has_depth.tolist(),
        "with_depth": bool(has_depth.any()),
    }
    (out_dir / META_NAME).write_text(json.dumps(meta))
    return meta


def is_packed(root: str | Path) -> bool:
    """True when ``root`` is a packed dataset root (has packed splits)."""
    root = Path(root)
    return (root / "train" / META_NAME).exists() or (root / "val" / META_NAME).exists()


class _PackedSplit:
    """Memmapped arrays + meta for one packed split."""

    def __init__(self, root: str | Path, split: str):
        d = Path(root) / split
        self.meta = json.loads((d / META_NAME).read_text())
        H, W, n = self.meta["height"], self.meta["width"], self.meta["n_frames"]
        self.images = np.memmap(d / "images.u8", mode="r", dtype=np.uint8,
                                shape=(n, H, W, 3))
        self.depth = None
        if self.meta["with_depth"]:
            self.depth = np.memmap(d / "depth.f32", mode="r", dtype=np.float32,
                                   shape=(n, H, W))
        self.intrinsics = np.fromfile(d / "intrinsics.f32",
                                      dtype=np.float32).reshape(-1, 3, 3)
        self.has_depth = np.asarray(self.meta["has_depth"], dtype=bool)
        self.scene_bounds = self.meta["scene_bounds"]


class PackedSequenceDataset:
    """Snippet samples {tgt, ref_imgs, intrinsics[, depth]} built from scene
    bounds; shuffled with ``random.Random(seed).shuffle`` so a seed gives the
    JAX package's sample order."""

    def __init__(self, root: str | Path, seed: int | None = None, train: bool = True,
                 sequence_length: int = 3, with_depth: bool = False,
                 shuffle: bool = True, uint8: bool = False):
        self.split = _PackedSplit(root, "train" if train else "val")
        self.uint8 = uint8
        self.sequence_length = sequence_length
        self.with_depth = with_depth
        demi = (sequence_length - 1) // 2
        samples: list[tuple[int, int, list[int]]] = []  # (scene, tgt, refs)
        for s, (lo, hi) in enumerate(self.split.scene_bounds):
            if hi - lo < sequence_length:
                continue
            for i in range(lo + demi, hi - demi):
                if with_depth and not self.split.has_depth[i]:
                    continue
                refs = [i + j for j in range(-demi, demi + 1) if j != 0]
                samples.append((s, i, refs))
        if with_depth and self.split.depth is None and samples:
            raise ValueError("with_depth=True but the split packed no depth")
        if shuffle:
            random.Random(seed).shuffle(samples)
        self.samples = samples

    def __len__(self) -> int:
        return len(self.samples)

    def _img(self, sel):
        raw = self.split.images[sel]
        return np.asarray(raw) if self.uint8 else raw.astype(np.float32) / 255.0

    def get_batch(self, ids) -> dict[str, np.ndarray]:
        """Whole batch in vectorized gathers (used by BatchLoader)."""
        picked = [self.samples[i] for i in ids]
        scene_ids = np.fromiter((p[0] for p in picked), np.int64)
        tgt_ids = np.fromiter((p[1] for p in picked), np.int64)
        out = {"tgt": self._img(tgt_ids),
               "intrinsics": self.split.intrinsics[scene_ids].copy()}
        n_refs = self.sequence_length - 1
        if n_refs:
            ref_ids = np.asarray([p[2] for p in picked], np.int64)  # (B, R)
            refs = self._img(ref_ids.ravel())
            out["ref_imgs"] = refs.reshape(ref_ids.shape + refs.shape[1:])
        else:
            out["ref_imgs"] = np.zeros((len(picked), 0) + self.split.images.shape[1:],
                                       np.uint8 if self.uint8 else np.float32)
        if self.with_depth:
            out["depth"] = np.asarray(self.split.depth[tgt_ids])
        return out


class PackedValidationSet:
    """(img, depth) pairs from the val split, restricted to frames with GT."""

    def __init__(self, root: str | Path, uint8: bool = False):
        self.uint8 = uint8
        self.split = _PackedSplit(root, "val")
        if self.split.depth is None:
            raise FileNotFoundError("packed val split has no GT depth")
        self.frame_ids = np.nonzero(self.split.has_depth)[0]

    def __len__(self) -> int:
        return len(self.frame_ids)

    def get_batch(self, ids) -> dict[str, np.ndarray]:
        f = self.frame_ids[np.asarray(ids, np.int64)]
        raw = self.split.images[f]
        img = np.asarray(raw) if self.uint8 else raw.astype(np.float32) / 255.0
        return {"img": img, "depth": np.asarray(self.split.depth[f])}
