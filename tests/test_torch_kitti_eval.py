"""The port's copies of the Eigen-split harness
(``kitti_eval/depth_evaluation_utils.py``) and the file-list validators
(``data/filelist_validation.py``) against the JAX package's, on the same
inputs: a synthetic KITTI-raw tree (``kitti_eval/synthetic.py``) and
seeded predictions. The copies are the same numpy code, so results are
equal bit for bit, except where said."""

import numpy as np
import pytest

from supervised_dispnet_tpu.data import filelist_validation as jfl
from supervised_dispnet_tpu.kitti_eval import depth_evaluation_utils as jeu
from supervised_dispnet_tpu_torch.data import filelist_validation as pfl
from supervised_dispnet_tpu_torch.kitti_eval import depth_evaluation_utils as peu
from supervised_dispnet_tpu_torch.kitti_eval.synthetic import DATE, write_kitti_raw


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    return root, write_kitti_raw(root, seed=3, drives=2, frames=2, height=75, width=250,
                                 points=4000)


def test_read_calib_file_and_velo2cam_match(tree):
    root, _ = tree
    for name in ("calib_cam_to_cam.txt", "calib_velo_to_cam.txt"):
        want = jeu.read_calib_file(root / DATE / name)
        got = peu.read_calib_file(root / DATE / name)
        assert sorted(got) == sorted(want) and "calib_time" not in got
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(peu.velo2cam_matrix(root / DATE),
                                  jeu.velo2cam_matrix(root / DATE))


@pytest.mark.parametrize("use_native", [False, True])
def test_generate_depth_map_matches(tree, use_native):
    """Against JAX's numpy path and its C++ projector (which falls back to
    numpy where it cannot build): the same z-buffered map, bit-equal."""
    root, _ = tree
    velo = root / DATE / f"{DATE}_drive_0001_sync" / "velodyne_points" / "data" / "0000000001.bin"
    want = jeu.generate_depth_map(root / DATE, velo, (75, 250), use_native=use_native)
    got = peu.generate_depth_map(root / DATE, velo, (75, 250))
    assert (got > 0).sum() > 1000
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(75, 250), (375, 1242), (1, 1)])
def test_garg_crop_mask_matches(hw):
    np.testing.assert_array_equal(peu.garg_crop_mask(*hw), jeu.garg_crop_mask(*hw))


def _preds(gts, seed):
    rng = np.random.default_rng(seed)
    return [(g + rng.normal(0, 3, g.shape)).clip(0.5).astype(np.float32) * 1.3 for g in gts]


def test_compute_errors_matches():
    rng = np.random.default_rng(0)
    gt = rng.uniform(1, 80, 5000)
    pred = gt * rng.uniform(0.7, 1.4, 5000)
    assert peu.compute_errors(gt, pred) == jeu.compute_errors(gt, pred)


@pytest.mark.parametrize("median_scaling", [False, True])
def test_framework_and_evaluate_depth_match(tree, median_scaling):
    """The port's framework (its own PNG decoder) yields the frames and GT
    that JAX's (imageio) does, and ``evaluate_depth`` gives the same dict."""
    root, list_file = tree
    files = list_file.read_text().splitlines()
    got = list(peu.KittiEigenFramework(root, files))
    want = list(jeu.KittiEigenFramework(root, files))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["path"] == w["path"]
        np.testing.assert_array_equal(g["img"], w["img"])
        np.testing.assert_array_equal(g["gt_depth"], w["gt_depth"])
    gts = [s["gt_depth"] for s in want]
    preds = _preds(gts, 1)
    cfg = dict(max_depth=50.0, median_scaling=median_scaling)
    out = peu.evaluate_depth(gts, preds, peu.EvalConfig(**cfg))
    assert out == jeu.evaluate_depth(gts, preds, jeu.EvalConfig(**cfg))
    assert out["n_images"] == 4 and ("median_scale_mean" in out) == median_scaling


def test_validate_eigen_list_gives_the_same_errors(tmp_path, tree):
    _, list_file = tree
    lines = list_file.read_text().splitlines()
    broken = tmp_path / "broken.txt"
    broken.write_text("\n".join(lines[:2] + ["2011_09_26/not_a_drive/image_02/data/1.png",
                                             "2011_09_26/x.jpg"] * 12))
    scenes = tmp_path / "scenes.txt"
    scenes.write_text(f"{DATE}_drive_0001_sync\nbad scene\n")
    frames = tmp_path / "static.txt"
    frames.write_text(f"{DATE} {DATE}_drive_0001_sync 0000000001\n{DATE} x\n")
    for path in (list_file, broken):
        for count in (False, True):
            want = jfl.validate_eigen_list(path, expect_count=count)
            assert pfl.validate_eigen_list(path, expect_count=count) == want
    assert pfl.validate_eigen_list(list_file, expect_count=False) == []
    assert len(pfl.validate_eigen_list(broken, expect_count=False)) == 22  # 21 and a cut
    assert pfl.validate_test_scenes(scenes) == jfl.validate_test_scenes(scenes) != []
    assert pfl.validate_static_frames(frames) == jfl.validate_static_frames(frames) != []
    with pytest.raises(ValueError, match="malformed"):
        pfl.require_valid("eigen_list", broken)
    pfl.require_valid("eigen_list", list_file)
