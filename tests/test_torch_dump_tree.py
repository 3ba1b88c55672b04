"""The port's readers of a ``prepare_train_data`` dump tree against the JAX
package's, on the CPU: ``data/sequence_folders.py::SequenceFolder``,
``data/validation_folders.py::ValidationSet``, ``data/packed.py::pack_split``
and its CLI, and training from the tree through ``cli/train.py``.

- Samples equal JAX's one by one, bit for bit (uint8 and float, sequence
  lengths 1 / 3 / 5, with and without depth, the same shuffle for a seed):
  the frames are JPEGs written by cv2, as the JAX ETL writes them, and the
  port's decoder gives cv2's pixels exactly (``tests/test_torch_jpeg_codec.py``).
- ``pack_split`` writes ``images.u8``, ``depth.f32`` and ``intrinsics.f32``
  byte-equal to JAX's, and the same ``meta.json`` as a dict (a frame has
  depth when its ``.npy`` exists, as in JAX).
- ``BatchLoader`` over the folders gives JAX's loader's batches, for 1 and 3
  threads.
- The trainer's first train and val batches from the tree equal those from
  its packed root; ``cli/train.py`` takes 2 steps from the tree (BerHu with
  DispResNet-18, self-supervised with DispNetS + PoseExpNet, ``-j 2``);
  ``--loader device`` on a tree raises naming the pack CLI.
"""

import json
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest

from supervised_dispnet_tpu.data import loader as jax_loader
from supervised_dispnet_tpu.data import packed as jax_packed
from supervised_dispnet_tpu.data.sequence_folders import SequenceFolder as JaxSequenceFolder
from supervised_dispnet_tpu.data.validation_folders import ValidationSet as JaxValidationSet
from supervised_dispnet_tpu_torch.cli import train as train_cli
from supervised_dispnet_tpu_torch.data import packed
from supervised_dispnet_tpu_torch.data.loader import BatchLoader
from supervised_dispnet_tpu_torch.data.sequence_folders import SequenceFolder
from supervised_dispnet_tpu_torch.data.validation_folders import ValidationSet
from supervised_dispnet_tpu_torch.models import DispNetS, DispResNet, PoseExpNet
from supervised_dispnet_tpu_torch.training.trainer import Trainer, TrainerConfig
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

H, W = 64, 96
# scene -> (frames, frames without a depth dump)
SCENES = {"train": {"scene_a": (7, {2, 5}), "scene_b": (5, set())},
          "val": {"scene_c": (4, {1}), "scene_d": (3, set())}}


@pytest.fixture(scope="module")
def dump(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("dump")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:H, :W]
    for split, scenes in SCENES.items():
        (root / f"{split}.txt").write_text("".join(s + "\n" for s in scenes))
        for k, (name, (n, no_depth)) in enumerate(scenes.items()):
            d = root / name
            d.mkdir()
            K = np.array([[50.0 + k, 0, W / 2], [0, 51.0, H / 2], [0, 0, 1]])
            np.savetxt(d / "cam.txt", K, fmt="%.8f")
            np.savetxt(d / "poses.txt", rng.normal(size=(n, 12)), fmt="%.8e")
            for i in range(n):
                base = np.stack([(xx * 4 + 9 * i) % 256, yy * 4, (xx + yy + 30 * k) % 256], -1)
                img = np.clip(base + rng.normal(0, 10, base.shape), 0, 255).astype(np.uint8)
                cv2.imwrite(str(d / f"{i:010d}.jpg"), img[..., ::-1])
                if i not in no_depth:
                    depth = rng.uniform(1, 80, (H, W)) * (rng.uniform(size=(H, W)) < 0.3)
                    np.save(d / f"{i:010d}.npy", depth.astype(np.float32))
    return root


def _assert_samples_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("uint8", [True, False], ids=["uint8", "float"])
@pytest.mark.parametrize("sequence_length", [1, 3, 5])
@pytest.mark.parametrize("with_depth", [False, True], ids=["no_depth", "depth"])
def test_sequence_folder_matches_jax(dump, uint8, sequence_length, with_depth):
    kw = dict(seed=3, train=True, sequence_length=sequence_length, with_depth=with_depth,
              uint8=uint8)
    ours, theirs = SequenceFolder(dump, **kw), JaxSequenceFolder(dump, **kw)
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        _assert_samples_equal(ours[i], theirs[i])


def test_sequence_folder_reads_the_val_split_in_order(dump):
    kw = dict(train=False, sequence_length=3, shuffle=False, uint8=True)
    ours, theirs = SequenceFolder(dump, **kw), JaxSequenceFolder(dump, **kw)
    assert [s["tgt"] for s in ours.samples] == [s["tgt"] for s in theirs.samples]
    batch = ours.get_batch([0, 2, 1])
    for j, i in enumerate([0, 2, 1]):
        _assert_samples_equal({k: v[j] for k, v in batch.items()}, theirs[i])


@pytest.mark.parametrize("uint8", [True, False], ids=["uint8", "float"])
def test_validation_set_matches_jax(dump, uint8):
    ours, theirs = ValidationSet(dump, uint8=uint8), JaxValidationSet(dump, uint8=uint8)
    assert len(ours) == len(theirs) == 6
    for i in range(len(ours)):
        _assert_samples_equal(ours[i], theirs[i])


@pytest.mark.parametrize("split", ["train", "val"])
def test_pack_split_is_byte_equal_to_jax(dump, tmp_path, split):
    meta = packed.pack_split(dump, tmp_path / "port", split)
    want = jax_packed.pack_split(dump, tmp_path / "jax", split)
    assert meta == want
    assert json.loads((tmp_path / "port" / split / "meta.json").read_text()) == json.loads(
        (tmp_path / "jax" / split / "meta.json").read_text())
    for name in ("images.u8", "depth.f32", "intrinsics.f32"):
        assert ((tmp_path / "port" / split / name).read_bytes()
                == (tmp_path / "jax" / split / name).read_bytes()), name
    assert meta["has_depth"].count(False) == (2 if split == "train" else 1)


def test_pack_cli_packs_both_splits(dump, tmp_path, capsys):
    packed.main([str(dump), str(tmp_path / "p")])
    out = capsys.readouterr().out
    assert "packed train: 12 frames (2 scenes" in out and "packed val: 7 frames" in out
    assert packed.is_packed(tmp_path / "p")


@pytest.mark.parametrize("workers", [1, 3])
def test_batch_loader_over_folders_equals_jax_loader(dump, workers):
    kw = dict(seed=1, train=True, sequence_length=3, with_depth=True, uint8=True)
    ours = BatchLoader(SequenceFolder(dump, **kw), 2, shuffle=True, num_workers=workers,
                       seed=5)
    theirs = jax_loader.BatchLoader(JaxSequenceFolder(dump, **kw), 2, shuffle=True,
                                    num_workers=workers, seed=5)
    for _ in range(2):  # two epochs: each reshuffles
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            _assert_samples_equal(a, b)


@pytest.mark.parametrize("loss", ["berhu", "selfsup"])
def test_trainer_batches_from_the_tree_equal_its_packed_roots(dump, tmp_path, loss):
    for split in ("train", "val"):
        packed.pack_split(dump, tmp_path / "packed", split)
    batches = []
    for root in (dump, tmp_path / "packed"):
        cfg = TrainerConfig(data=str(root), batch_size=2, loss=loss, workers=2, seed=4,
                            save_path=str(tmp_path / "run"))
        nets = ((DispNetS(), PoseExpNet()) if loss == "selfsup" else (DispResNet(18), None))
        trainer = Trainer(cfg, nets[0], pose_model=nets[1], device="cpu")
        train, val = trainer.make_loaders()
        batches.append((next(iter(train)), next(iter(val)), trainer.val_with_gt))
    (t0, v0, gt0), (t1, v1, gt1) = batches
    assert gt0 is gt1 is True
    _assert_samples_equal(t0, t1)
    _assert_samples_equal(v0, v1)
    assert ("ref_imgs" in t0 and t0["ref_imgs"].shape[1] == 2) == (loss == "selfsup")


@pytest.mark.parametrize("args", [
    ["--network", "disp_res_18", "--loss", "berhu", "--with-gt"],
    ["--network", "dispnet", "--loss", "selfsup", "--sequence-length", "3", "-p", "1.0",
     "-m", "0.2", "-s", "0.1"],
], ids=["berhu", "selfsup"])
def test_cli_trains_two_steps_from_a_dump_tree(dump, tmp_path, args):
    trainer = train_cli.main([
        str(dump), *args, "-b", "2", "-j", "2", "--epoch-size", "2", "--epochs", "1",
        "--device", "cpu", "--checkpoints-dir", str(tmp_path / "ck"), "--name", "t"])
    assert trainer.step == 2 and trainer.cfg.workers == 2
    run = Path(trainer.cfg.save_path)
    events = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [e["loss"] for e in events if e["event"] == "train_iter"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    epoch = [e for e in events if e["event"] == "epoch"][0]
    assert np.isfinite(epoch["abs_rel"])
    shutil.rmtree(tmp_path / "ck")  # checked: the disk is shared by the whole suite


def test_device_loader_on_a_dump_tree_names_the_pack_cli(dump, tmp_path):
    cfg = TrainerConfig(data=str(dump), batch_size=2, loader="device",
                        save_path=str(tmp_path / "run"))
    with pytest.raises(ValueError, match="supervised_dispnet_tpu_torch.data.packed"):
        Trainer(cfg, DispResNet(18), device="cpu").make_loaders()
