"""The port's offline ETL (``data/prepare_train_data.py`` with
``kitti_raw_loader.py``, ``kitti_odometry_loader.py`` and
``cityscapes_loader.py``) against the JAX package's, on the CPU, on trees
like ``tests/test_etl.py``'s (frames written by cv2 as PNGs).

For KITTI raw (a static-frames list and Eigen test scenes, and the GPS
min-speed fallback without the list), odometry and Cityscapes:
- the same scene names and train / val split, the same ``cam.txt`` and
  ``poses.txt`` text and the same ``.npy`` depth, byte for byte;
- each frame before encoding equals JAX's (``cv2.imread`` + ``cv2.resize``
  ``INTER_AREA``) bit for bit: the port's decoder and
  ``resize_area_uint8`` follow cv2's arithmetic;
- each written JPEG, decoded by cv2, is within one level of JAX's on >= 99.9%
  identical pixels (the codec test's rule), and here the same bytes.

A subprocess runs the ETL and the folder reader with ``cv2``, ``PIL``,
``imageio``, ``joblib`` and JAX blocked in ``sys.modules``: the card's
machine has none of them.
"""

import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from supervised_dispnet_tpu.data import prepare_train_data as jax_etl
from supervised_dispnet_tpu.data.cityscapes_loader import CityscapesLoader as JaxCityscapes
from supervised_dispnet_tpu.data.kitti_odometry_loader import (
    KittiOdometryLoader as JaxOdometry)
from supervised_dispnet_tpu.data.kitti_raw_loader import KittiRawLoader as JaxKittiRaw
from supervised_dispnet_tpu_torch.data import prepare_train_data as etl
from supervised_dispnet_tpu_torch.data.cityscapes_loader import CityscapesLoader
from supervised_dispnet_tpu_torch.data.kitti_odometry_loader import KittiOdometryLoader
from supervised_dispnet_tpu_torch.data.kitti_raw_loader import KittiRawLoader
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

REPO = Path(__file__).resolve().parents[1]
DATE = "2011_09_26"


def _frame(rng, H, W):
    yy, xx = np.mgrid[:H, :W]
    base = np.stack([(xx * 2 + yy) % 256, yy * 3 % 256, (xx + 50) % 256], -1)
    return np.clip(base + rng.normal(0, 15, base.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def kitti_raw(tmp_path_factory) -> Path:
    """One date, three drives of 5 frames at 75x250 (a non-integer ratio to
    32x104, as KITTI's 375x1242 to 128x416), calib, velodyne, oxts; drive 1
    stands still for its first two frames. ``static_frames.txt`` lists frame
    1 of drive 1 and frame 3 of drive 2; drive 3 is a test scene."""
    root = tmp_path_factory.mktemp("kitti_raw")
    date_dir = root / DATE
    date_dir.mkdir()
    H, W = 75, 250
    P = np.array([[90.0, 0, W / 2, 0], [0, 90.0, H / 2, 0], [0, 0, 1, 0]])
    (date_dir / "calib_cam_to_cam.txt").write_text(
        "R_rect_00: " + " ".join(map(str, np.eye(3).ravel())) + "\n"
        + "".join(f"P_rect_0{c}: " + " ".join(map(str, P.ravel())) + "\n" for c in (2, 3)))
    R = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=float)
    (date_dir / "calib_velo_to_cam.txt").write_text(
        "R: " + " ".join(map(str, R.ravel())) + "\nT: 0 0 0\n")
    rng = np.random.default_rng(0)
    for d in (1, 2, 3):
        drive = date_dir / f"{DATE}_drive_{d:04d}_sync"
        dirs = [drive / "image_02" / "data", drive / "velodyne_points" / "data",
                drive / "oxts" / "data"]
        for p in dirs:
            p.mkdir(parents=True)
        for i in range(5):
            cv2.imwrite(str(dirs[0] / f"{i:010d}.png"), _frame(rng, H, W))
            pts = np.hstack([rng.uniform(4, 40, (400, 1)), rng.uniform(-8, 8, (400, 1)),
                             rng.uniform(-1.5, 1, (400, 1)), np.ones((400, 1))])
            pts.astype(np.float32).tofile(dirs[1] / f"{i:010d}.bin")
            speed = 0.0 if (d == 1 and i < 2) else 5.0 + i
            vals = [49.0 + i * 1e-5 * d, 8.43 + i * 2e-5, 112.0 + 0.01 * i, 0.01 * d, 0.02,
                    0.1 * i, speed * 0.6, speed * 0.8] + [0.0] * 22
            np.savetxt(dirs[2] / f"{i:010d}.txt", [vals])
    (root / "static_frames.txt").write_text(
        f"{DATE} {DATE}_drive_0001_sync 0000000001\n{DATE} {DATE}_drive_0002_sync 0000000003\n")
    (root / "test_scenes.txt").write_text(f"{DATE}_drive_0003_sync\n")
    return root


@pytest.fixture(scope="module")
def odometry_tree(tmp_path_factory) -> Path:
    """Sequences 00, 01 and the test sequence 09 at 64x130, calib and poses."""
    rng = np.random.default_rng(3)
    H, W = 64, 130
    root = tmp_path_factory.mktemp("odometry")
    for seq in ("00", "01", "09"):
        img_dir = root / "sequences" / seq / "image_2"
        img_dir.mkdir(parents=True)
        for i in range(5):
            cv2.imwrite(str(img_dir / f"{i:06d}.png"), _frame(rng, H, W))
        P2 = np.array([[70.0, 0, W / 2, 0.1], [0, 70.0, H / 2, 0], [0, 0, 1, 0]])
        (root / "sequences" / seq / "calib.txt").write_text(
            "P0: " + " ".join(map(str, P2.ravel())) + "\n"
            "P2: " + " ".join(map(str, P2.ravel())) + "\n")
        (root / "poses").mkdir(exist_ok=True)
        np.savetxt(root / "poses" / f"{seq}.txt", rng.normal(size=(5, 12)))
    return root


@pytest.fixture(scope="module")
def cityscapes_tree(tmp_path_factory) -> Path:
    """Two cities, two sequences in one, 3 frames each at 64x128."""
    root = tmp_path_factory.mktemp("cs")
    rng = np.random.default_rng(1)
    for city, seqs in (("aachen", ("000000", "000001")), ("bochum", ("000002",))):
        img_dir = root / "leftImg8bit_sequence" / "train" / city
        cam_dir = root / "camera" / "train" / city
        img_dir.mkdir(parents=True)
        cam_dir.mkdir(parents=True)
        for seq in seqs:
            for i in range(3):
                cv2.imwrite(str(img_dir / f"{city}_{seq}_{i:06d}_leftImg8bit.png"),
                            _frame(rng, 64, 128))
                cam = {"intrinsic": {"fx": 2262.52, "fy": 2265.3, "u0": 1096.98,
                                     "v0": 513.137 + i}}
                (cam_dir / f"{city}_{seq}_{i:06d}_camera.json").write_text(json.dumps(cam))
    return root


def _run_both(src: Path, tmp_path: Path, args: list[str]) -> tuple[Path, Path]:
    common = [str(src), *args, "--height", "32", "--width", "104", "--val-frac", "0.5"]
    etl.main([*common, "--dump-root", str(tmp_path / "port"), "--num-threads", "2"])
    jax_etl.main([*common, "--dump-root", str(tmp_path / "jax"), "--num-threads", "1"])
    return tmp_path / "port", tmp_path / "jax"


def _assert_dumps_equal(port: Path, jax: Path, n_scenes: int):
    for name in ("train.txt", "val.txt"):
        assert (port / name).read_text() == (jax / name).read_text(), name
    scenes = sorted(d.name for d in port.iterdir() if d.is_dir())
    assert scenes == sorted(d.name for d in jax.iterdir() if d.is_dir())
    assert len(scenes) == n_scenes
    listed = ((port / "train.txt").read_text() + (port / "val.txt").read_text()).split()
    assert sorted(listed) == scenes
    for scene in scenes:
        files = sorted(p.name for p in (port / scene).iterdir())
        assert files == sorted(p.name for p in (jax / scene).iterdir()), scene
        for name in files:
            a, b = port / scene / name, jax / scene / name
            if name.endswith(".jpg"):
                x, y = cv2.imread(str(a)), cv2.imread(str(b))
                assert np.abs(x.astype(int) - y).max() <= 1 and (x == y).all(-1).mean() >= 0.999
                assert a.read_bytes() == b.read_bytes(), a
            elif name.endswith(".npy"):
                x, y = np.load(a), np.load(b)
                assert x.dtype == y.dtype == np.float32
                np.testing.assert_array_equal(x, y)
            else:  # cam.txt, poses.txt
                assert a.read_text() == b.read_text(), a


def _assert_frames_equal(ours, theirs, scene_pairs):
    """Each frame before encoding, intrinsics and raw shape, bit for bit."""
    for s, t in scene_pairs:
        assert [f.name for f in s["frames"]] == [f.name for f in t["frames"]]
        for i in range(len(s["frames"])):
            (a, Ka, ra), (b, Kb, rb) = ours.load_image(s, i), theirs.load_image(t, i)
            assert a.dtype == b.dtype == np.uint8 and tuple(ra) == tuple(rb)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(Ka, Kb)


@pytest.mark.parametrize("static", [True, False], ids=["static_frames", "min_speed"])
def test_kitti_etl_matches_jax(kitti_raw, tmp_path, static):
    args = ["--with-depth", "--with-pose", "--test-scenes", str(kitti_raw / "test_scenes.txt")]
    if static:
        args += ["--static-frames", str(kitti_raw / "static_frames.txt")]
    port, jax = _run_both(kitti_raw, tmp_path, args)
    _assert_dumps_equal(port, jax, n_scenes=2)
    kept = sorted(p.stem for p in (port / f"{DATE}_drive_0001_sync_02").glob("*.jpg"))
    assert kept == ([f"{i:010d}" for i in (0, 2, 3, 4)] if static
                    else [f"{i:010d}" for i in (2, 3, 4)])  # stationary frames dropped
    assert np.loadtxt(port / f"{DATE}_drive_0001_sync_02" / "poses.txt").shape == (
        len(kept), 12)
    kw = dict(img_height=32, img_width=104, get_depth=True, get_pose=True,
              static_frames_file=kitti_raw / "static_frames.txt" if static else None,
              test_scene_file=kitti_raw / "test_scenes.txt")
    ours, theirs = KittiRawLoader(kitti_raw, **kw), JaxKittiRaw(kitti_raw, **kw)
    assert ours.scenes == theirs.scenes and len(ours.scenes) == 2
    pairs = [(s, t) for d in range(2) for s, t in zip(ours.collect_scene_data(ours.scenes[d]),
                                                       theirs.collect_scene_data(theirs.scenes[d]))]
    for s, t in pairs:
        np.testing.assert_array_equal(s["poses"], t["poses"])
        for i in range(len(s["frames"])):
            np.testing.assert_array_equal(ours.get_depth_map(s, i), theirs.get_depth_map(t, i))
    _assert_frames_equal(ours, theirs, pairs)


def test_odometry_etl_matches_jax(odometry_tree, tmp_path):
    port, jax = _run_both(odometry_tree, tmp_path, ["--dataset-format", "odometry",
                                                    "--with-pose"])
    _assert_dumps_equal(port, jax, n_scenes=2)  # 09 is a test sequence
    assert (port / "seq_00" / "poses.txt").is_file()
    kw = dict(img_height=32, img_width=104)
    ours, theirs = KittiOdometryLoader(odometry_tree, **kw), JaxOdometry(odometry_tree, **kw)
    _assert_frames_equal(ours, theirs, [
        (next(ours.collect_scene_data(a)), next(theirs.collect_scene_data(b)))
        for a, b in zip(ours.scenes, theirs.scenes)])
    with pytest.raises(ValueError, match="with-depth"):
        KittiOdometryLoader(odometry_tree, get_depth=True)


def test_cityscapes_etl_matches_jax(cityscapes_tree, tmp_path):
    port, jax = _run_both(cityscapes_tree, tmp_path, ["--dataset-format", "cityscapes"])
    _assert_dumps_equal(port, jax, n_scenes=3)
    kw = dict(img_height=32, img_width=104)
    ours, theirs = CityscapesLoader(cityscapes_tree, **kw), JaxCityscapes(cityscapes_tree, **kw)
    _assert_frames_equal(ours, theirs, list(zip(ours.collect_scene_data(),
                                                theirs.collect_scene_data())))


def test_etl_refuses_a_malformed_static_frames_list(kitti_raw, tmp_path):
    bad = tmp_path / "static_frames.txt"
    bad.write_text("garbage\n")
    with pytest.raises(ValueError, match="malformed"):
        etl.main([str(kitti_raw), "--dump-root", str(tmp_path / "d"),
                  "--static-frames", str(bad)])


def test_etl_and_folder_reader_run_without_image_libraries(kitti_raw, tmp_path):
    """The card's machine has no cv2, PIL, imageio or joblib: the ETL, the
    folder reader and the pack CLI run with each blocked (and JAX too)."""
    dump, packed_root = tmp_path / "dump", tmp_path / "packed"
    code = f"""
import json, sys
for m in ("cv2", "PIL", "imageio", "joblib", "jax", "supervised_dispnet_tpu"):
    sys.modules[m] = None
from supervised_dispnet_tpu_torch.data import packed, prepare_train_data
from supervised_dispnet_tpu_torch.data.sequence_folders import SequenceFolder
from supervised_dispnet_tpu_torch.data.validation_folders import ValidationSet
prepare_train_data.main([{str(kitti_raw)!r}, "--dump-root", {str(dump)!r}, "--with-depth",
    "--with-pose", "--height", "32", "--width", "104", "--val-frac", "0.5",
    "--test-scenes", {str(kitti_raw / "test_scenes.txt")!r}])
ds = SequenceFolder({str(dump)!r}, seed=0, sequence_length=3, with_depth=True, uint8=True)
batch = ds.get_batch(range(len(ds)))
val = ValidationSet({str(dump)!r})
packed.main([{str(dump)!r}, {str(packed_root)!r}])
print(json.dumps({{"n": len(ds), "shape": list(batch["ref_imgs"].shape), "val": len(val)}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["n"] > 0 and got["shape"] == [got["n"], 2, 32, 104, 3] and got["val"] > 0
    assert (packed_root / "train" / "meta.json").is_file()
