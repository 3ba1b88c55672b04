"""The port's Eigen error suite against the JAX package's, on the CPU, and
against values worked out by hand."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.losses.metrics import compute_errors as jax_compute_errors
from supervised_dispnet_tpu_torch.losses.metrics import compute_errors
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

KEYS = {"abs_diff", "abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3"}


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_compute_errors_matches_jax(with_mask, seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(1.0, 80.0, (2, 16, 24)).astype(np.float32)
    pred = (gt * rng.uniform(0.6, 1.6, gt.shape)).astype(np.float32)
    mask = (rng.uniform(size=gt.shape) < 0.3) if with_mask else None
    ref = jax_compute_errors(jnp.asarray(gt), jnp.asarray(pred),
                             None if mask is None else jnp.asarray(mask))
    got = compute_errors(torch.from_numpy(gt), torch.from_numpy(pred),
                         None if mask is None else torch.from_numpy(mask))
    assert set(got) == set(ref) == KEYS
    for k in KEYS:
        assert got[k].shape == ()
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_compute_errors_by_hand():
    """Two valid pixels (gt 10 and 20, pred 12.5 and 20) and one masked out:
    abs_diff 1.25, abs_rel 0.125, sq_rel 0.3125, rmse sqrt(3.125),
    rmse_log |log 0.8| / sqrt 2, a1 0.5 (12.5 / 10 = 1.25 is not < 1.25)."""
    gt = torch.tensor([10.0, 20.0, 5.0])
    pred = torch.tensor([12.5, 20.0, 50.0])
    mask = torch.tensor([True, True, False])
    e = {k: float(v) for k, v in compute_errors(gt, pred, mask).items()}
    assert e["abs_diff"] == pytest.approx(1.25)
    assert e["abs_rel"] == pytest.approx(0.125)
    assert e["sq_rel"] == pytest.approx(0.3125)
    assert e["rmse"] == pytest.approx(np.sqrt(3.125))
    assert e["rmse_log"] == pytest.approx(abs(np.log(0.8)) / np.sqrt(2), rel=1e-6)
    assert (e["a1"], e["a2"], e["a3"]) == (0.5, 1.0, 1.0)


def test_compute_errors_empty_mask_is_zero():
    gt = torch.full((4, 4), 10.0)
    e = compute_errors(gt, gt * 2, torch.zeros(4, 4, dtype=torch.bool))
    assert all(float(v) == 0.0 for v in e.values())
