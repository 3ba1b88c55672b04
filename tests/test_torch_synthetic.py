"""The port's copy of the synthetic ego-motion scenes
(``supervised_dispnet_tpu_torch/data/synthetic.py``) against the JAX
package's: from the same seed, the renders (snippet batches, with and
without the corridor and the floating quads, and a sequence) and the
metrics (``pose_errors``, ``scaled_abs_rel``) are bit-identical, since both
are the same numpy code. Then ``scripts/torch_convergence_check.py`` runs a
few steps of each task on the CPU (two threads, as ``tests/torch_threads.py``
caps the port's tests) and prints its JSON line."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from supervised_dispnet_tpu.data import synthetic as jsyn
from supervised_dispnet_tpu_torch.data import synthetic as tsyn

REPO = Path(__file__).resolve().parents[1]
SMALL = {"height": 32, "width": 64, "texture_size": 128}


def _equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("scene", [{}, {"fg_planes": 2, "room": True, "rot": 0.04}])
def test_render_batch_is_bit_identical_to_jax(scene):
    cfg = dict(SMALL, **scene)
    _equal(tsyn.render_batch(np.random.default_rng(5), 2, tsyn.PlaneSceneConfig(**cfg)),
           jsyn.render_batch(np.random.default_rng(5), 2, jsyn.PlaneSceneConfig(**cfg)))


def test_render_sequence_and_metrics_are_bit_identical_to_jax():
    cfg = dict(SMALL, fg_planes=1, room=True)
    seq_t = tsyn.render_sequence(np.random.default_rng(6), 4, tsyn.PlaneSceneConfig(**cfg))
    seq_j = jsyn.render_sequence(np.random.default_rng(6), 4, jsyn.PlaneSceneConfig(**cfg))
    seq_t["intrinsics"], seq_j["intrinsics"] = seq_t["intrinsics"][None], seq_j["intrinsics"][None]
    _equal(seq_t, seq_j)
    rng = np.random.default_rng(7)
    pred, gt = rng.normal(0, 0.1, (3, 2, 6)), rng.normal(0, 0.1, (3, 2, 6))
    assert tsyn.pose_errors(pred, gt) == jsyn.pose_errors(pred, gt)
    d_pred, d_gt = rng.uniform(1, 50, (3, 8, 16)), rng.uniform(1, 50, (3, 8, 16))
    assert tsyn.scaled_abs_rel(d_pred, d_gt) == jsyn.scaled_abs_rel(d_pred, d_gt)
    np.testing.assert_array_equal(tsyn.euler_to_mat_np(pred[..., 3:]),
                                  jsyn.euler_to_mat_np(pred[..., 3:]))


@pytest.mark.parametrize("argv", [
    ["--steps", "2", "--batch", "2", "--network", "disp_res_18"],
    ["--loss", "selfsup", "--steps", "2", "--batch", "2", "--pool", "2",
     "--stochastic-photo", "2"],
])
def test_convergence_script_runs_a_few_steps_on_the_cpu(argv):
    out = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_convergence_check.py"), *argv,
         "--height", "32", "--width", "64", "--eval-every", "1", "--device", "cpu"],
        cwd=REPO, check=True, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "2"}).stdout  # as tests/torch_threads.py
    result = json.loads(out.strip().splitlines()[-1])
    assert result["device"] == "cpu" and result["steps"] == 2 and result["card"] is None
    if "--loss" in argv:
        assert result["stochastic_photo"] == 2 and len(result["curve"]) == 2
        for m in (result["initial"], result["final"]):
            assert all(np.isfinite(v) for v in m.values())
    else:
        assert np.isfinite(result["initial"]) and np.isfinite(result["final"])
