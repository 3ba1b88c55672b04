"""The port's loaders on the CPU: the device-resident split
(``data/device_cache.py``, ``--loader device``), the host loader's gather
threads (``-j``) and ``--steps-per-dispatch``.

- The device cache's batches, gathered by the trainer, equal the host
  loader's (``BatchLoader(PackedSequenceDataset)`` through
  ``prep_train_batch``) bit for bit, dtypes included, over 2 epochs of an
  ``epoch_size`` below the split, for supervised batches (fp16 depth) and
  self-supervised snippets; a loader resumed at epoch 1 continues the same
  stream; k-step blocks hold the same batches in order.
- Its index tables equal the JAX package's ``DeviceResidentSequence``'s.
- ``BatchLoader`` gives the same batches for 1 and 3 worker threads.
- A self-supervised trainer (DispNetS + PoseExpNet, 32x64, B=2) takes the
  same steps, bit for bit, with ``--loader device`` as with ``--loader
  threads``, and with ``-f 2`` writes the same training-output images
  (the first snippet gathered from the resident split); 2 steps a dispatch
  end on the same parameters as single steps, and log the means of the same
  losses (rtol 1e-6: a float32 mean of two).
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.data.device_cache import (
    DeviceResidentSequence as JaxDeviceResidentSequence)
from supervised_dispnet_tpu_torch.cli import train as train_cli
from supervised_dispnet_tpu_torch.data.device_cache import DeviceResidentSequence
from supervised_dispnet_tpu_torch.data.loader import BatchLoader
from supervised_dispnet_tpu_torch.data.packed import PackedSequenceDataset, write_split
from supervised_dispnet_tpu_torch.models import DispNetS, PoseExpNet
from supervised_dispnet_tpu_torch.training.trainer import Trainer, TrainerConfig
from supervised_dispnet_tpu_torch.utils.logging import (
    CsvLogger, JsonlLogger, NoopWriter, TermLogger)
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

H, W, B = 32, 64, 2


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    """Two scenes of 9 and 7 frames a split, ~30% sparse depth (frames 4
    and 11 without any)."""
    root = tmp_path_factory.mktemp("packed")
    rng = np.random.default_rng(0)
    K = np.array([[40.0, 0, W / 2], [0, 41.0, H / 2], [0, 0, 1]], np.float32)
    for split in ("train", "val"):
        images = rng.integers(0, 256, (16, H, W, 3), dtype=np.uint8)
        depth = (rng.uniform(1, 80, (16, H, W)) * (rng.uniform(size=(16, H, W)) < 0.3))
        depth[[4, 11]] = 0
        write_split(root / split, images, np.stack([K, K * 1.1]), [(0, 9), (9, 16)],
                    depth.astype(np.float32))
    return root


def _trainer(root: Path, loss: str, **cfg) -> Trainer:
    selfsup = loss == "selfsup"
    conv = torch.nn.Conv2d(3, 1, 1)
    return Trainer(TrainerConfig(data=str(root), loss=loss, batch_size=B, seed=3,
                                 epoch_size=3, **cfg),
                   conv, torch.nn.Conv2d(3, 1, 1) if selfsup else None, device="cpu")


def _batches(trainer: Trainer, epochs: int, start_epoch: int = 0) -> list[dict]:
    loader = trainer.make_loaders()[0]
    loader.epoch = start_epoch
    k = trainer.cfg.steps_per_dispatch
    out = []
    for _ in range(epochs):
        for item in loader:
            if k == 1:
                out.append(trainer.prep_train_batch(item))
                continue
            idx = trainer._device_data.upload(item)
            out += [trainer._device_data.gather({n: v[j] for n, v in idx.items()})
                    for j in range(k)]
    return out


def _same(a: list[dict], b: list[dict]) -> None:
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]), k


@pytest.mark.parametrize("loss", ["berhu", "selfsup"])
def test_device_batches_equal_the_host_loaders_bit_for_bit(root, loss):
    host = _batches(_trainer(root, loss), 2)
    assert {k: v.dtype for k, v in host[0].items()} == (
        {"tgt": torch.uint8, "ref_imgs": torch.uint8, "intrinsics": torch.float32}
        if loss == "selfsup" else
        {"tgt": torch.uint8, "intrinsics": torch.float32, "depth": torch.float16})
    _same(_batches(_trainer(root, loss, loader="device"), 2), host)
    # a resumed loader continues the stream
    _same(_batches(_trainer(root, loss, loader="device"), 1, start_epoch=1), host[3:])
    # k-step blocks: an epoch of 3 batches is 1 block of 2
    blocks = _batches(_trainer(root, loss, loader="device", steps_per_dispatch=2), 2)
    _same(blocks, host[0:2] + host[3:5])


@pytest.mark.parametrize("sequence_length,with_depth", [(1, True), (3, False)])
def test_index_tables_match_jax(root, sequence_length, with_depth):
    kw = dict(train=True, sequence_length=sequence_length, with_depth=with_depth, seed=3,
              epoch_size=5)
    port = DeviceResidentSequence(root, B, "cpu", **kw)
    ref = JaxDeviceResidentSequence(root, B, **kw)
    assert len(port) == len(ref)
    for _ in range(2):
        for a, b in zip(port, ref, strict=True):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(port.images.numpy(), np.asarray(ref.images))
    if with_depth:
        np.testing.assert_array_equal(port.depth.numpy(), np.asarray(ref.depth))
    np.testing.assert_array_equal(port.intrinsics.numpy(), np.asarray(ref.intrinsics))
    jax.clear_caches()


def test_device_cache_refusals(root, tmp_path):
    with pytest.raises(ValueError, match="budget"):
        DeviceResidentSequence(root, B, "cpu", hbm_budget_bytes=1000)
    write_split(tmp_path / "train", np.zeros((4, H, W, 3), np.uint8),
                np.eye(3, dtype=np.float32)[None], [(0, 4)])
    with pytest.raises(FileNotFoundError, match="no GT depth"):
        DeviceResidentSequence(tmp_path, B, "cpu", sequence_length=1, with_depth=True)
    with pytest.raises(ValueError, match="loader='device'"):
        _trainer(root, "berhu", steps_per_dispatch=2).make_loaders()


def test_worker_counts_give_the_same_batches(root):
    ds = PackedSequenceDataset(root, seed=1, train=True, sequence_length=3, uint8=True)
    runs = {}
    for j in (1, 3):
        loader = BatchLoader(ds, B, num_workers=j, seed=1)
        runs[j] = [b for _ in range(2) for b in loader]
    assert len(runs[1]) == 2 * (len(ds) // B)
    for a, b in zip(runs[1], runs[3], strict=True):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    args = train_cli.parse_args([str(root), "-j", "3", "--loader", "device",
                                 "--steps-per-dispatch", "4"])
    assert (args.workers, args.loader, args.steps_per_dispatch) == (3, "device", 4)


class RecordingWriter(NoopWriter):
    def __init__(self):
        self.images = []

    def add_image(self, tag, img, step):
        self.images.append((tag, step, np.asarray(img)))


def _train(root: Path, tmp: Path, **cfg) -> tuple[Trainer, list[float]]:
    """One epoch of 4 self-supervised steps of seeded DispNetS + PoseExpNet,
    training-output images every 2 loader items; returns the trainer (its
    ``tb`` holds the images) and its logged losses."""
    torch.manual_seed(0)
    trainer = Trainer(TrainerConfig(data=str(root), save_path=str(tmp), loss="selfsup",
                                    batch_size=B, seed=3, epoch_size=4,
                                    training_output_freq=2, **cfg),
                      DispNetS(generator=torch.Generator().manual_seed(0)),
                      PoseExpNet(generator=torch.Generator().manual_seed(1)), device="cpu")
    trainer.tb = RecordingWriter()
    loader = trainer.make_loaders()[0]
    logger = TermLogger(1, len(loader), 1)
    jsonl = JsonlLogger(tmp / "metrics.jsonl")
    trainer.train_epoch(loader, logger, CsvLogger(tmp), jsonl)
    jsonl.close()
    events = [json.loads(x) for x in (tmp / "metrics.jsonl").read_text().splitlines()]
    return trainer, [(e["step"], e["loss"]) for e in events]


def _params(trainer: Trainer) -> list[torch.Tensor]:
    return [p.detach().clone() for net in (trainer.model, trainer.pose_model)
            for p in net.parameters()]


def test_device_loader_and_dispatch_train_as_the_threads_loader(root, tmp_path):
    threads, t_log = _train(root, tmp_path / "threads")
    device, d_log = _train(root, tmp_path / "device", loader="device")
    block, b_log = _train(root, tmp_path / "block", loader="device", steps_per_dispatch=2)
    assert [s for s, _ in t_log] == [s for s, _ in d_log] == [1, 2, 3, 4]
    assert d_log == t_log
    assert [s for s, _ in b_log] == [2, 4]
    np.testing.assert_allclose([v for _, v in b_log],
                               [(t_log[0][1] + t_log[1][1]) / 2,
                                (t_log[2][1] + t_log[3][1]) / 2], rtol=1e-6)
    for other in (device, block):
        assert other.update.micro_step == threads.update.micro_step == 4
        assert all(torch.equal(a, b) for a, b in zip(_params(other), _params(threads)))
    tags = ["train/disp", "train/input", "train/warped", "train/diff"]
    # after steps 1 and 3 (items 0 and 2); a block's after steps 2 and 4
    assert [(t, n) for t, n, _ in threads.tb.images] == [(t, n) for n in (1, 3) for t in tags]
    assert [(t, n) for t, n, _ in block.tb.images] == [(t, 2) for t in tags]
    for (_, _, a), (_, _, b) in zip(device.tb.images, threads.tb.images, strict=True):
        np.testing.assert_array_equal(a, b)
