"""The port's int8 serving surfaces on the CPU: ``DepthService(int8=True)``,
``cli/serve.py --int8 --calib-dir``, ``cli/test_disp.py`` and
``cli/run_inference.py`` with ``--int8 --calib-batches --percentile``, and
``cli/train.py --qat``.

Here each side calibrates its own ranges, from float forwards that agree
to ~1e-5 (``tests/test_torch_quant.py``): the int8 grids then differ by as
much, codes move by one here and there, and a random DispNetS carries that
to its depth. The JAX side also jits its int8 forward, whose CPU rewrites
round the epilogues otherwise. Held, with the values measured:
- the service's depth (init weights): median rel <= 5e-3, max <= 5e-2
  (1.5e-3, 1.5e-2);
- ``run_inference``'s depths (a seeded DispNetS): median rel <= 2e-2, max
  <= 0.1 (7.5e-3, 5.0e-2);
- the eval CLI's Eigen errors rtol 1e-3 (4.2e-5), the threshold fractions
  a1..a3 within 2e-4 absolute (a pixel is 4.2e-5 of them; 8.3e-5).
The HTTP server against the port's own int8 service on the same
calibration: rtol 1e-6. The int8 service against the float one at JAX's
threshold for DispNetS (``tests/test_quant.py``: median rel < 0.02)."""

import io
import threading
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.cli import run_inference as jax_run_inference
from supervised_dispnet_tpu.cli import test_disp as jax_test_disp
from supervised_dispnet_tpu.kitti_eval import depth_evaluation_utils as jeu
from supervised_dispnet_tpu.models import DispNetS as JaxDispNetS
from supervised_dispnet_tpu.serving import DepthService as JaxDepthService
from supervised_dispnet_tpu.serving import ServingConfig as JaxServingConfig
from supervised_dispnet_tpu_torch.cli import run_inference, serve, test_disp
from supervised_dispnet_tpu_torch.cli import train as train_cli
from supervised_dispnet_tpu_torch.kitti_eval.synthetic import DATE
from supervised_dispnet_tpu_torch.models import DispNetS
from supervised_dispnet_tpu_torch.serving import DepthService, ServingConfig
from supervised_dispnet_tpu_torch.utils.convert import dispnet_from_jax
from supervised_dispnet_tpu_torch.utils.image_io import write_png
from tests.test_torch_eval_cli import SIZE, _eval_args
from tests.test_torch_eval_cli import data  # noqa: F401  (the synthetic tree fixture)
from tests.test_torch_port import _packed_split
from tests.torch_quant_ref import rel_err
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

H, W = 32, 64
TIMEOUT = 60.0


def _near_jax(got: np.ndarray, want: np.ndarray, med: float, top: float) -> None:
    rel = rel_err(got, want)
    assert np.median(rel) <= med and rel.max() <= top, (np.median(rel), rel.max())


@pytest.fixture(scope="module")
def nets():
    jmodel = JaxDispNetS()
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    params = jax.device_get(variables["params"])
    port = DispNetS()
    port.load_state_dict(dispnet_from_jax(params), strict=True)
    return jmodel, params, port.eval()


def _calibration(seed=5, n=3):
    return list(np.random.default_rng(seed).integers(0, 256, (n, H, W, 3), dtype=np.uint8))


def test_int8_service_matches_jax_and_stays_near_float(nets):
    jmodel, params, port = nets
    cfg = dict(img_height=H, img_width=W, buckets=(4,), int8=True)
    calib = _calibration()
    imgs = np.random.default_rng(2).integers(0, 256, (4, H, W, 3), dtype=np.uint8)
    want = JaxDepthService(jmodel, {"params": params}, JaxServingConfig(**cfg),
                           calibration=calib).predict(imgs)
    svc = DepthService(port, ServingConfig(**cfg), device="cpu", calibration=calib)
    assert svc.ranges and all(k.endswith("Conv_0") for k in svc.ranges)
    fp = DepthService(port, ServingConfig(img_height=H, img_width=W, buckets=(4,)),
                      device="cpu")
    got = svc.predict(imgs)
    _near_jax(got, want, 5e-3, 5e-2)
    assert np.median(rel_err(got, fp.predict(imgs))) < 0.02
    with svc:
        np.testing.assert_array_equal(svc.submit(imgs[0]).result(timeout=TIMEOUT),
                                      svc.predict(imgs[:1])[0])
    with pytest.raises(ValueError, match="calibration"):
        DepthService(port, ServingConfig(**cfg), device="cpu")


def test_http_server_int8_serves_the_calibrated_service(nets, tmp_path):
    _, _, port = nets
    torch.save({"state_dict": port.state_dict()}, tmp_path / "d.pth.tar")
    calib_dir = tmp_path / "calib"
    calib_dir.mkdir()
    frames = np.random.default_rng(7).integers(0, 256, (10, H, W, 3), dtype=np.uint8)
    for i, f in enumerate(frames):
        write_png(calib_dir / f"{i:02d}.png", f)
    args = ["--pretrained", str(tmp_path / "d.pth.tar"), "--network", "dispnet",
            "--img-height", str(H), "--img-width", str(W), "--buckets", "1,2",
            "--port", "0", "--device", "cpu"]
    with pytest.raises(SystemExit):
        serve.make_server([*args, "--int8"])
    httpd, svc = serve.make_server([*args, "--int8", "--calib-dir", str(calib_dir)])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/depth",
                                     data=(calib_dir / "09.png").read_bytes(), method="POST")
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            depth = np.load(io.BytesIO(r.read()))
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.stop()
        thread.join(timeout=TIMEOUT)
    # the first 8 files, as the JAX example takes them
    want = DepthService(port, ServingConfig(img_height=H, img_width=W, buckets=(1, 2),
                                            int8=True),
                        device="cpu", calibration=list(frames[:8])).predict(frames[9])
    assert svc.ranges is not None
    np.testing.assert_allclose(depth, want[0], rtol=1e-6, atol=1e-6)


def test_eval_cli_int8_matches_jax(data, monkeypatch):  # noqa: F811
    extra = ["--int8", "--calib-batches", "2", "--percentile", "99.9", "--batch-size", "2"]
    captured = {}
    evaluate = jeu.evaluate_depth

    def capture(gts, preds, cfg):
        captured.update(evaluate(gts, preds, cfg))
        return evaluate(gts, preds, cfg)

    with monkeypatch.context() as mp:
        mp.setattr(jeu, "evaluate_depth", capture)
        jax_test_disp.main(_eval_args(data, *extra))
    got = test_disp.main(_eval_args(data, *extra, "--device", "cpu"))
    fp = test_disp.main(_eval_args(data, "--batch-size", "2", "--device", "cpu"))
    for k, v in captured.items():
        if k in ("a1", "a2", "a3"):  # fractions of pixels: a few pixels either way
            assert abs(got[k] - v) <= 2e-4, (k, got[k], v)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-3, err_msg=k)
    assert any(got[k] != fp[k] for k in got)  # the int8 batches bite


def test_run_inference_int8_matches_jax(data, tmp_path):  # noqa: F811
    root, _, ckpt = data
    frames = root / "raw" / DATE / f"{DATE}_drive_0001_sync" / "image_02" / "data"
    args = ["--pretrained", str(ckpt), "--network", "dispnet", "--dataset-dir", str(frames),
            *SIZE, "--save-npy", "--int8", "--calib-batches", "1", "--percentile", "99.9"]
    jax_run_inference.main([*args, "--output-dir", str(tmp_path / "jax")])
    run_inference.main([*args, "--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    stems = sorted(f.stem for f in frames.glob("*.png"))
    assert len(stems) == 3
    for stem in stems:
        _near_jax(np.load(tmp_path / "port" / f"{stem}_depth.npy"),
                  np.load(tmp_path / "jax" / f"{stem}_depth.npy"), 2e-2, 0.1)


def test_train_cli_qat_takes_two_steps(tmp_path):
    _packed_split(tmp_path / "data", 64, 96)
    trainer = train_cli.main([
        str(tmp_path / "data"), "--network", "disp_res_18", "--loss", "berhu", "-b", "2",
        "--epoch-size", "2", "--epochs", "1", "--qat", "--device", "cpu",
        "--checkpoints-dir", str(tmp_path / "ck"), "--name", "q"])
    assert trainer.step == 2 and trainer.cfg.qat
    assert (Path(trainer.cfg.save_path) / "metrics.jsonl").is_file()
    with pytest.raises(NotImplementedError, match="--spatial-shards"):
        train_cli.main([str(tmp_path / "data"), "--qat", "--spatial-shards", "2",
                        "--device", "cpu"])
