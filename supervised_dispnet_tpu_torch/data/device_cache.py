"""Device-resident dataset, the port of
``supervised_dispnet_tpu/data/device_cache.py``: the whole packed train
split lives in device memory, and each batch is gathered there from a few
hundred bytes of host indices.

The packed images are uploaded once as uint8 (and the GT depth as float16,
the train step's transport dtypes); each epoch yields index dicts, and
``gather`` builds the batch on the device with ``index_select``. Batches are
bit-identical to ``BatchLoader(PackedSequenceDataset)``'s: the same sample
table, the same shuffle law (``np.random.default_rng(seed + epoch)`` over
the sample order), ``drop_last``, ``epoch_size`` and the ``epoch`` that a
resume sets.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from supervised_dispnet_tpu_torch.data.packed import PackedSequenceDataset

UPLOAD_FRAMES = 256  # frames a host->device copy while uploading the split


def _upload(arr: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A memmapped array on ``device`` as ``dtype``, copied in chunks of
    ``UPLOAD_FRAMES`` frames (the host never holds a second full copy)."""
    out = torch.empty(arr.shape, dtype=dtype, device=device)
    for lo in range(0, arr.shape[0], UPLOAD_FRAMES):
        chunk = torch.from_numpy(np.array(arr[lo:lo + UPLOAD_FRAMES]))
        out[lo:lo + len(chunk)].copy_(chunk)
    return out


class DeviceResidentSequence:
    """Epoch iterable of index dicts over a packed train split held on
    ``device``: {'tgt_idx': (B,), 'scene_idx': (B,)} int64 numpy arrays, and
    'ref_idx' (B, R) for snippets; with ``steps_per_item`` k > 1, each item
    stacks k of them, (k, B[, R]), and an epoch is a whole number of items.
    ``upload`` sends an item's indices to the device in one copy, and
    ``gather`` builds the batch there: {'tgt', 'intrinsics'[, 'ref_imgs']
    [, 'depth']}."""

    def __init__(self, root: str | Path, batch_size: int, device: str | torch.device,
                 train: bool = True, sequence_length: int = 3, with_depth: bool = False,
                 seed: int = 0, shuffle: bool = True, epoch_size: int | None = None,
                 hbm_budget_bytes: int = 10 * 1024 ** 3, steps_per_item: int = 1):
        # the dataset's own shuffle with the same seed: the sample order, and
        # so every batch, is BatchLoader(PackedSequenceDataset)'s
        ds = PackedSequenceDataset(root, seed=seed, train=train,
                                   sequence_length=sequence_length,
                                   with_depth=with_depth, shuffle=shuffle, uint8=True)
        self.device = torch.device(device)
        self.sequence_length = sequence_length
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.steps_per_item = max(1, steps_per_item)
        n_batches = len(ds.samples) // batch_size
        self.epoch_size = min(epoch_size, n_batches) if epoch_size else n_batches
        self.epoch_size -= self.epoch_size % self.steps_per_item

        split = ds.split
        if with_depth and split.depth is None:
            raise FileNotFoundError(
                f"{root}: the packed train split has no GT depth; train with "
                "--loss selfsup or pack a split with depth")
        need = split.images.nbytes + (split.depth.size * 2 if with_depth else 0)
        if need > hbm_budget_bytes:
            raise ValueError(
                f"device-resident split needs {need / 1e9:.1f} GB > budget "
                f"{hbm_budget_bytes / 1e9:.1f} GB; use --loader threads")
        self.images = _upload(split.images, torch.uint8, self.device)
        self.depth = (_upload(split.depth, torch.float16, self.device) if with_depth
                      else None)
        self.intrinsics = torch.from_numpy(split.intrinsics.copy()).to(self.device)

        samples = ds.samples  # [(scene, tgt, refs)]
        self._scene = np.asarray([s for s, _, _ in samples], np.int64)
        self._tgt = np.asarray([t for _, t, _ in samples], np.int64)
        self._refs = np.asarray([r for _, _, r in samples], np.int64)

    def __len__(self) -> int:
        return self.epoch_size // self.steps_per_item

    def _index_batch(self, sel: np.ndarray) -> dict[str, np.ndarray]:
        out = {"tgt_idx": self._tgt[sel], "scene_idx": self._scene[sel]}
        if self.sequence_length > 1:
            out["ref_idx"] = self._refs[sel]
        return out

    def __iter__(self):
        order = np.arange(len(self._tgt))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        B, K = self.batch_size, self.steps_per_item
        for i in range(self.epoch_size // K):
            batches = [self._index_batch(order[(i * K + k) * B:(i * K + k + 1) * B])
                       for k in range(K)]
            if K == 1:
                yield batches[0]
            else:
                yield {key: np.stack([b[key] for b in batches]) for key in batches[0]}

    def upload(self, item: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """An item's index arrays on the device, in one host->device copy."""
        keys = sorted(item)
        flat = torch.from_numpy(np.concatenate([item[k].ravel() for k in keys]))
        flat = flat.to(self.device)
        out, at = {}, 0
        for k in keys:
            n = item[k].size
            out[k] = flat[at:at + n].view(item[k].shape)
            at += n
        return out

    def gather(self, idx: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """One batch from its index tensors (on the device), gathered there."""
        tgt = idx["tgt_idx"]
        batch = {"tgt": self.images.index_select(0, tgt),
                 "intrinsics": self.intrinsics.index_select(0, idx["scene_idx"])}
        if "ref_idx" in idx:
            ref = idx["ref_idx"]
            batch["ref_imgs"] = self.images.index_select(0, ref.reshape(-1)).view(
                *ref.shape, *self.images.shape[1:])
        if self.depth is not None:
            batch["depth"] = self.depth.index_select(0, tgt)
        return batch
