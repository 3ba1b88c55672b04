"""The port's eval and inference CLIs (``cli/test_disp.py``,
``cli/run_inference.py``) against the JAX package's, on the CPU, on one
synthetic KITTI-raw tree (75x250 frames, resized to 32x104: KITTI's kind
of non-integer ratio) and one ``.pth.tar`` of a seeded port DispNetS, which
the JAX CLIs read through their own converter.

The seven Eigen metrics, the ``--output-dir`` predictions and the ``.npy``
depths agree to rtol 1e-4: the same float32 network on the same CPU, and
host resizes that match cv2's to ~1e-7 (``tests/test_torch_image_io.py``).
The depth and disparity PNGs are colour-mapped (matplotlib's ``magma``, a
table of 256 colours): each pixel's colour is within one entry of the
table of JAX's, the colour map's grey level (a value on an entry's edge can
fall either way: depths differ by ~2e-6 relative)."""

import sys

import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.cli import run_inference as jax_run_inference
from supervised_dispnet_tpu.cli import test_disp as jax_test_disp
from supervised_dispnet_tpu.kitti_eval import depth_evaluation_utils as jeu
from supervised_dispnet_tpu_torch.cli import run_inference, test_disp
from supervised_dispnet_tpu_torch.kitti_eval.synthetic import DATE, write_kitti_raw
from supervised_dispnet_tpu_torch.models import get_disp_net
from supervised_dispnet_tpu_torch.utils.image_io import read_png
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

SIZE = ["--img-height", "32", "--img-width", "104"]
METRICS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The tree, its list and a DispNetS checkpoint."""
    root = tmp_path_factory.mktemp("eval")
    list_file = write_kitti_raw(root / "raw", seed=2, drives=2, frames=3, height=75,
                                width=250, points=6000)
    model = get_disp_net("dispnet", seed=4, device="cpu")
    ckpt = root / "dispnet_model_best.pth.tar"
    torch.save({"epoch": 1, "state_dict": model.state_dict()}, ckpt)
    return root, list_file, ckpt


def _eval_args(data, *extra):
    root, list_file, ckpt = data
    return ["--pretrained-dispnet", str(ckpt), "--network", "dispnet",
            "--dataset-dir", str(root / "raw"), "--dataset-list", str(list_file),
            *SIZE, "--batch-size", "4", *extra]


@pytest.fixture(scope="module", params=[False, True],
                ids=["no_scaling", "median_scaling_imagenet_normalization"])
def both_evals(request, data, tmp_path_factory):
    """Both CLIs' metrics and ``predictions.npy``, without or with
    ``--median-scaling`` (and ImageNet input normalisation); JAX's
    full-precision metrics are read from its ``evaluate_depth`` call (it
    prints them to 4 decimals)."""
    extra = ["--median-scaling", "--imagenet-normalization"] if request.param else []
    out = tmp_path_factory.mktemp("out")
    captured = {}
    evaluate = jeu.evaluate_depth

    def capture(gts, preds, cfg):
        captured.update(evaluate(gts, preds, cfg))
        return evaluate(gts, preds, cfg)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeu, "evaluate_depth", capture)
        jax_test_disp.main(_eval_args(data, *extra, "--output-dir", str(out / "jax")))
    port = test_disp.main(_eval_args(data, *extra, "--output-dir", str(out / "port"),
                                     "--device", "cpu"))
    return request.param, captured, port, out


def test_eval_cli_metrics_and_predictions_match_jax(both_evals):
    median_scaling, want, got, out = both_evals
    assert got["n_images"] == want["n_images"] == 6
    assert ("median_scale_mean" in got) == median_scaling
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert 0 < got["abs_rel"] and got["a3"] <= 1
    preds = np.load(out / "port" / "predictions.npy", allow_pickle=True)
    jax_preds = np.load(out / "jax" / "predictions.npy", allow_pickle=True)
    assert len(preds) == len(jax_preds) == 6
    for p, j in zip(preds, jax_preds):
        assert p.shape == j.shape == (75, 250)
        np.testing.assert_allclose(p.astype(np.float32), j.astype(np.float32), rtol=1e-4)


def test_eval_cli_prints_the_metric_table(data, capsys):
    results = test_disp.main(_eval_args(data, "--median-scaling", "--device", "cpu"))
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].split() == list(METRICS)
    assert [float(v) for v in lines[-1].split()] == [round(results[k], 4) for k in METRICS]


def _magma_level(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 of ``save_depth_png`` -> (H, W) index into the colour
    map's 256-entry table (every pixel must be one of its colours)."""
    import matplotlib

    table = (matplotlib.colormaps["magma"](np.arange(256))[:, :3].astype(np.float32)
             * 255).astype(np.uint8)
    match = (rgb[:, :, None, :] == table[None, None]).all(-1)
    assert match.any(-1).all()
    return match.argmax(-1)


def test_run_inference_outputs_match_jax(data, tmp_path):
    root, _, ckpt = data
    frames = root / "raw" / DATE / f"{DATE}_drive_0001_sync" / "image_02" / "data"
    args = ["--pretrained", str(ckpt), "--network", "dispnet", "--dataset-dir", str(frames),
            *SIZE, "--save-npy", "--output-disp", "--output-depth", "--batch-size", "2"]
    jax_run_inference.main([*args, "--output-dir", str(tmp_path / "jax")])
    run_inference.main([*args, "--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    stems = sorted(f.stem for f in frames.glob("*.png"))
    assert len(stems) == 3
    for stem in stems:
        got = np.load(tmp_path / "port" / f"{stem}_depth.npy")
        assert got.shape == (32, 104) and (got > 0).all()
        np.testing.assert_allclose(got, np.load(tmp_path / "jax" / f"{stem}_depth.npy"),
                                   rtol=1e-4)
        for kind in ("disp", "depth"):
            a = _magma_level(read_png(tmp_path / "port" / f"{stem}_{kind}.png"))
            b = _magma_level(read_png(tmp_path / "jax" / f"{stem}_{kind}.png"))
            assert a.shape == b.shape == (32, 104)
            assert np.abs(a - b).max() <= 1


def test_fused_decoder_and_no_resize_through_the_eval_cli(tmp_path):
    """On frames already at the network's 32x96, ``--no-resize
    --fused-upsample`` with a DispResNet-18 checkpoint gives the metrics of
    the resized (here: unchanged) unfused run, rtol 1e-4: the fused stage
    equals the unfused one to float32 rounding."""
    list_file = write_kitti_raw(tmp_path / "raw", seed=5, drives=1, frames=2, height=32,
                                width=96, points=3000)
    ckpt = tmp_path / "disp_res_18.pth.tar"
    torch.save({"state_dict": get_disp_net("disp_res_18", seed=1, device="cpu").state_dict()},
               ckpt)
    args = ["--pretrained-dispnet", str(ckpt), "--network", "disp_res_18",
            "--dataset-dir", str(tmp_path / "raw"), "--dataset-list", str(list_file),
            "--img-height", "32", "--img-width", "96", "--median-scaling", "--device", "cpu"]
    fused = test_disp.main([*args, "--fused-upsample", "--no-resize"])
    plain = test_disp.main(args)
    for k in METRICS:
        np.testing.assert_allclose(fused[k], plain[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("flag", ["--int8", "--calib-batches", "--percentile"])
def test_unported_int8_flags_raise(data, tmp_path, flag):
    value = [] if flag == "--int8" else ["2"]
    with pytest.raises(NotImplementedError, match=flag):
        test_disp.main(_eval_args(data, flag, *value, "--device", "cpu"))
    with pytest.raises(NotImplementedError, match=flag):
        run_inference.main(["--pretrained", str(data[2]), "--dataset-dir", str(tmp_path),
                            "--output-dir", str(tmp_path), flag, *value, "--device", "cpu"])


def test_orbax_directory_raises(data, tmp_path):
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="JAX package"):
        test_disp.main(["--pretrained-dispnet", str(tmp_path / "orbax"),
                        *_eval_args(data, "--device", "cpu")[2:]])


def test_run_inference_names_non_png_files_it_cannot_decode(data, tmp_path, monkeypatch):
    """Without imageio, a JPEG in the folder raises before any forward."""
    (tmp_path / "frames").mkdir()
    (tmp_path / "frames" / "a.jpg").write_bytes(b"\xff\xd8\xff")
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(RuntimeError, match="a.jpg"):
        run_inference.main(["--pretrained", str(data[2]), "--dataset-dir",
                            str(tmp_path / "frames"), "--output-dir", str(tmp_path / "o"),
                            "--device", "cpu"])
    assert not list((tmp_path / "o").iterdir())
