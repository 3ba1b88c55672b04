"""The port's model export (``utils/export.py``) on the CPU: ``torch.export``
programs of the float and the int8 forward, fixed and dynamic batch, and of
the pose net, saved, loaded back and held against the live forward bit for
bit (the same float32 and int8 operations in the same order), the int8
program smaller than the float one (it stores the int8 weights, as JAX's
``tests/test_io_extras.py`` holds its artifact), and a fresh process that
imports only the int8 op's module loading and running an int8 program."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from supervised_dispnet_tpu_torch.models import PoseExpNet, get_disp_net
from supervised_dispnet_tpu_torch.ops import quant as pq
from supervised_dispnet_tpu_torch.utils import export as ex
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

H, W = 32, 64
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    out = tmp_path_factory.mktemp("export")
    model = get_disp_net("disp_res_18", fused_upsample=True, seed=1, device="cpu").eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (3, H, W, 3)).astype(np.float32))
    ranges = pq.calibrate_conv_ranges(model, [x])
    paths = {}
    for kind, kw in (("fp", {}), ("int8", {"int8_ranges": ranges})):
        for batch in (3, "dynamic"):
            paths[kind, batch] = out / f"{kind}-{batch}.pt2"
            ex.export_forward(model, paths[kind, batch], batch_size=batch, img_height=H,
                              img_width=W, **kw)
    return model, x, ranges, paths


@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("batch", [3, "dynamic"])
def test_round_trip_matches_the_live_forward(setup, kind, batch):
    model, x, ranges, paths = setup
    fwd = ex.load_forward(paths[kind, batch])
    live = model if kind == "fp" else pq.QuantizedModel(model, ranges)
    with torch.no_grad():
        want = live(x)[0]
        torch.testing.assert_close(fwd(x), want, rtol=0, atol=0)
        if batch == "dynamic":
            torch.testing.assert_close(fwd(x[:1]), live(x[:1])[0], rtol=0, atol=0)


def test_int8_program_is_smaller(setup):
    _, _, _, paths = setup
    fp, q = paths["fp", "dynamic"].stat().st_size, paths["int8", "dynamic"].stat().st_size
    assert q < 0.5 * fp, (q, fp)


@pytest.mark.parametrize("batch", [2, "dynamic"])
def test_pose_export_round_trip(tmp_path, batch):
    pose = PoseExpNet(nb_ref_imgs=2).eval()
    rng = np.random.default_rng(1)
    tgt = torch.from_numpy(rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32))
    refs = torch.from_numpy(rng.uniform(-1, 1, (2, 2, H, W, 3)).astype(np.float32))
    ex.export_pose_forward(pose, tmp_path / "pose.pt2", nb_ref_imgs=2, batch_size=batch,
                           img_height=H, img_width=W)
    fwd = ex.load_forward(tmp_path / "pose.pt2")
    with torch.no_grad():
        want = pose(tgt, [refs[:, 0], refs[:, 1]])[1]
        got = fwd(tgt, refs)
    assert got.shape == (2, 2, 6)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fresh_process_loads_the_int8_program(setup, tmp_path):
    model, x, ranges, paths = setup
    np.save(tmp_path / "x.npy", x.numpy())
    with torch.no_grad():
        np.save(tmp_path / "want.npy", pq.QuantizedModel(model, ranges)(x)[0].numpy())
    code = (
        "import sys, numpy as np, torch\n"
        "import supervised_dispnet_tpu_torch.ops.cuda.int8_conv\n"
        f"ep = torch.export.load({str(paths['int8', 'dynamic'])!r}).module()\n"
        f"x = torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r}))\n"
        "with torch.no_grad():\n"
        "    y = ep(x).numpy()\n"
        f"assert np.array_equal(y, np.load({str(tmp_path / 'want.npy')!r}))\n"
        "assert 'supervised_dispnet_tpu_torch.ops.quant' not in sys.modules\n"
        "assert 'jax' not in sys.modules\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]
