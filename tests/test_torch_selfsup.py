"""The port's self-supervised losses (``losses/selfsup.py``) against the JAX
package's ``losses/selfsup.py`` on the CPU in fp32: the multi-scale
photometric loss (with and without explainability masks, euler and quat
rotations, zeros and border padding) with its gradients in depth, pose and
mask; the explainability and smoothness terms with theirs. Loss rtol 1e-5;
gradients rtol 1e-4 / atol 1e-4 of the largest (the warp's coordinates agree
to fp32 rounding, and the L1's and the masks' kinks are where the two may
part). JAX runs its default sampler (the XLA form); the coordinates are
random, so none is an exact integer (see ``test_torch_sampling.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.losses import selfsup as js
from supervised_dispnet_tpu_torch.losses import selfsup as ts
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

B, H, W, R = 2, 32, 64, 2


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    refs = [rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32) for _ in range(R)]
    K = np.tile(np.array([[40.0, 0, W / 2 - 0.4], [0, 42.0, H / 2 + 0.3], [0, 0, 1]],
                         np.float32), (B, 1, 1))
    depths = [rng.uniform(1.0, 8.0, (B, H >> s, W >> s)).astype(np.float32)
              for s in range(4)]
    masks = [rng.uniform(0.05, 1.0, (B, H >> s, W >> s, R)).astype(np.float32)
             for s in range(4)]
    pose = (rng.standard_normal((B, R, 6)) * 0.05).astype(np.float32)
    return tgt, refs, K, depths, masks, pose


def _close(got, ref, rtol, scale_atol=0.0, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=scale_atol * float(np.abs(ref).max()), err_msg=msg)


@pytest.mark.parametrize("with_masks,rotation_mode,padding_mode", [
    (True, "euler", "zeros"), (False, "euler", "zeros"), (True, "quat", "border"),
    (False, "euler", "border")])
def test_photometric_loss_and_gradients_match_jax(with_masks, rotation_mode, padding_mode):
    tgt, refs, K, depths, masks, pose = _inputs()

    def jax_loss(depths, pose, masks):
        loss, warped = js.photometric_reconstruction_loss(
            jnp.asarray(tgt), [jnp.asarray(r) for r in refs], jnp.asarray(K), depths,
            masks if with_masks else None, pose, rotation_mode=rotation_mode,
            padding_mode=padding_mode)
        return loss, warped

    j_args = ([jnp.asarray(d) for d in depths], jnp.asarray(pose),
              [jnp.asarray(m) for m in masks])
    (j_loss, j_warped), j_grads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True))(*j_args)

    t_depths = [torch.from_numpy(d).requires_grad_(True) for d in depths]
    t_pose = torch.from_numpy(pose).requires_grad_(True)
    t_masks = [torch.from_numpy(m).requires_grad_(True) for m in masks]
    t_loss, t_warped = ts.photometric_reconstruction_loss(
        torch.from_numpy(tgt), [torch.from_numpy(r) for r in refs], torch.from_numpy(K),
        t_depths, t_masks if with_masks else None, t_pose, rotation_mode=rotation_mode,
        padding_mode=padding_mode)
    t_loss.backward()

    _close(t_loss.item(), j_loss, rtol=1e-5)
    assert len(t_warped) == len(j_warped) == R
    for a, b in zip(t_warped, j_warped):
        _close(a.detach(), b, rtol=1e-5, scale_atol=1e-4)
    for s in range(4):
        _close(t_depths[s].grad, j_grads[0][s], rtol=1e-4, scale_atol=1e-4, msg=f"depth {s}")
        if with_masks:
            _close(t_masks[s].grad, j_grads[2][s], rtol=1e-4, scale_atol=1e-4,
                   msg=f"mask {s}")
        else:
            assert t_masks[s].grad is None
    _close(t_pose.grad, j_grads[1], rtol=1e-4, scale_atol=1e-4, msg="pose")


def test_explainability_loss_and_gradient_match_jax():
    masks = _inputs(1)[4]
    masks[0][0, 0, 0, 0] = 0.0  # clamped to 1e-6: no gradient there
    j_loss, j_grads = jax.value_and_grad(js.explainability_loss)(
        [jnp.asarray(m) for m in masks])
    t_masks = [torch.from_numpy(m).requires_grad_(True) for m in masks]
    t_loss = ts.explainability_loss(t_masks)
    t_loss.backward()
    _close(t_loss.item(), j_loss, rtol=1e-5)
    for t, g in zip(t_masks, j_grads):
        _close(t.grad, g, rtol=1e-5, scale_atol=1e-7)


@pytest.mark.parametrize("with_channel", [True, False])
def test_smooth_loss_and_gradient_match_jax(with_channel):
    rng = np.random.default_rng(2)
    disps = [rng.uniform(0.01, 10.0, (B, H >> s, W >> s) + ((1,) if with_channel else ()))
             .astype(np.float32) for s in range(4)]
    j_loss, j_grads = jax.jit(jax.value_and_grad(js.smooth_loss))(
        [jnp.asarray(d) for d in disps])
    t_disps = [torch.from_numpy(d).requires_grad_(True) for d in disps]
    t_loss = ts.smooth_loss(t_disps)
    t_loss.backward()
    _close(t_loss.item(), j_loss, rtol=1e-5)
    for t, g in zip(t_disps, j_grads):
        _close(t.grad, g, rtol=1e-5, scale_atol=1e-6)


def test_scale_intrinsics_matches_jax():
    K = _inputs()[2]
    for f in (1.0, 0.5, 0.125):
        _close(ts._scale_intrinsics(torch.from_numpy(K), f),
               js._scale_intrinsics(jnp.asarray(K), f), rtol=1e-7)


@pytest.mark.parametrize("kw", [{"half_res_photo": True},
                                {"remat_photo": True, "batch_refs": True},
                                {"batch_refs": True}, {"stochastic_photo": 2}])
def test_unported_photometric_arms_raise(kw):
    """Every photometric arm is ported (``test_torch_photometric_arms.py``
    holds them); what the self-supervised step still refuses, beside each
    of them, is QAT (``fake_quant``)."""
    from supervised_dispnet_tpu_torch.models import DispNetS, PoseExpNet
    from supervised_dispnet_tpu_torch.training.train_step import make_selfsup_train_step

    disp, pose = DispNetS(), PoseExpNet()
    opt = torch.optim.Adam([*disp.parameters(), *pose.parameters()])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_selfsup_train_step(disp, pose, opt, fake_quant=True, **kw)
