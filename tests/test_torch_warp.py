"""The port's camera geometry (``ops/warp.py``) against the JAX package's
``ops/warp.py`` on the CPU in fp32: rotations, pose matrices, back-projection,
projection with its validity mask, and the whole inverse warp with its
gradients in image, depth and pose. Geometry rtol 1e-5 (the 3x3 products sum
in other orders). The warped image: atol 1e-4, because the pixel coordinates
agree to fp32 rounding (~1e-5 px at 64 px) and a unit-variance noise image
changes by up to ~3 per pixel. Gradients rtol 1e-4 / atol 1e-4 of the
largest (measured: ~1e-5 of it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.ops import warp as jw
from supervised_dispnet_tpu_torch.ops import warp as tw

B, H, W = 2, 32, 64


def _K(B=B, H=H, W=W):
    K = np.array([[50.0, 0.0, W / 2 - 0.3], [0.0, 48.0, H / 2 + 0.2], [0.0, 0.0, 1.0]],
                 np.float32)
    return np.tile(K, (B, 1, 1))


def _pose(rng, B=B, scale=0.05):
    return (rng.standard_normal((B, 6)) * scale).astype(np.float32)


def _close(got, ref, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=msg)


def test_euler2mat_and_quat2mat_match_jax():
    v = (np.random.default_rng(0).standard_normal((5, 3)) * 0.7).astype(np.float32)
    _close(tw.euler2mat(torch.from_numpy(v)), jw.euler2mat(jnp.asarray(v)))
    _close(tw.quat2mat(torch.from_numpy(v)), jw.quat2mat(jnp.asarray(v)))


@pytest.mark.parametrize("rotation_mode", ["euler", "quat"])
def test_pose_vec2mat_matches_jax(rotation_mode):
    v = _pose(np.random.default_rng(1), B=4, scale=0.5)
    _close(tw.pose_vec2mat(torch.from_numpy(v), rotation_mode),
           jw.pose_vec2mat(jnp.asarray(v), rotation_mode))


def test_pixel2cam_and_cam2pixel_match_jax():
    rng = np.random.default_rng(2)
    depth = rng.uniform(0.5, 20.0, (B, H, W)).astype(np.float32)
    K_inv = np.linalg.inv(_K()).astype(np.float32)
    cam_t = tw.pixel2cam(torch.from_numpy(depth), torch.from_numpy(K_inv))
    cam_j = jw.pixel2cam(jnp.asarray(depth), jnp.asarray(K_inv))
    _close(cam_t, cam_j)
    # a pose that sends part of the view out of bounds and some points behind
    pose = _pose(rng, scale=0.3)
    proj = _K() @ np.asarray(jw.pose_vec2mat(jnp.asarray(pose)))
    for bounds in (None, (H // 2, W // 2)):
        xt, yt, vt = tw.cam2pixel(cam_t, torch.from_numpy(proj[:, :, :3]),
                                  torch.from_numpy(proj[:, :, 3:]), bounds=bounds)
        xj, yj, vj = jw.cam2pixel(cam_j, jnp.asarray(proj[:, :, :3]),
                                  jnp.asarray(proj[:, :, 3:]), bounds=bounds)
        _close(xt, xj, rtol=1e-5, atol=1e-4)
        _close(yt, yj, rtol=1e-5, atol=1e-4)
        near_edge = ((np.abs(np.asarray(xj) + 1e-3) < 1e-3)
                     | (np.abs(np.asarray(xj) - (W - 1 + 1e-3)) < 1e-3))
        agree = vt.numpy() == np.asarray(vj)
        assert (agree | near_edge).all()
        assert 0 < vt.numpy().mean() < 1


@pytest.mark.parametrize("rotation_mode,padding_mode", [
    ("euler", "zeros"), ("quat", "border"), ("euler", "border")])
def test_inverse_warp_and_its_gradients_match_jax(rotation_mode, padding_mode):
    """diff_img=True (the default): values and the gradients in img, depth
    and pose, against the JAX warp on its per-corner Pallas sampler in
    interpret mode (the port's sampler's form)."""
    rng = np.random.default_rng(3)
    img = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    depth = rng.uniform(1.0, 10.0, (B, H, W)).astype(np.float32)
    pose = _pose(rng)
    K = _K()
    cot = rng.standard_normal((B, H, W, 3)).astype(np.float32)

    def jax_loss(i, d, p):
        warped, valid = jw.inverse_warp(i, d, p, jnp.asarray(K), rotation_mode,
                                        padding_mode, use_pallas=True)
        return jnp.sum(warped * cot * valid[..., None])

    j_args = [jnp.asarray(a) for a in (img, depth, pose)]
    j_warped, j_valid = jw.inverse_warp(*j_args, jnp.asarray(K), rotation_mode, padding_mode)
    j_grads = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(*j_args)

    t_args = [torch.from_numpy(a).requires_grad_(True) for a in (img, depth, pose)]
    t_warped, t_valid = tw.inverse_warp(*t_args, torch.from_numpy(K), rotation_mode,
                                        padding_mode)
    (t_warped * torch.from_numpy(cot) * t_valid[..., None]).sum().backward()
    assert (t_valid.numpy() == np.asarray(j_valid)).mean() > 0.999
    _close(t_warped.detach(), j_warped, rtol=1e-5, atol=1e-4)
    for t, g, name in zip(t_args, j_grads, ("img", "depth", "pose")):
        _close(t.grad, g, rtol=1e-4, atol=1e-4 * float(np.abs(np.asarray(g)).max()),
               msg=name)


def test_inverse_warp_diff_img_false_keeps_img_out_of_the_graph():
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.standard_normal((1, 16, 24, 3)).astype(np.float32))
    img.requires_grad_(True)
    depth = torch.from_numpy(rng.uniform(1.0, 5.0, (1, 16, 24)).astype(np.float32))
    pose = torch.from_numpy(_pose(rng, B=1)).requires_grad_(True)
    warped, _ = tw.inverse_warp(img, depth, pose, torch.from_numpy(_K(1, 16, 24)),
                                diff_img=False)
    warped.sum().backward()
    assert img.grad is None and pose.grad is not None


def test_inverse_warp_with_target_intrinsics_matches_jax():
    """A target grid other than the source's (``tgt_intrinsics``, bounds
    from the source image)."""
    rng = np.random.default_rng(5)
    img = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    depth = rng.uniform(1.0, 10.0, (B, H // 2, W // 2)).astype(np.float32)
    pose = _pose(rng)
    K, Kt = _K(), _K()
    Kt[:, :2] *= 0.5
    t_w, t_v = tw.inverse_warp(*(torch.from_numpy(a) for a in (img, depth, pose, K)),
                               tgt_intrinsics=torch.from_numpy(Kt))
    j_w, j_v = jw.inverse_warp(*(jnp.asarray(a) for a in (img, depth, pose, K)),
                               tgt_intrinsics=jnp.asarray(Kt))
    _close(t_w, j_w, rtol=1e-5, atol=1e-4)
    assert (t_v.numpy() == np.asarray(j_v)).mean() > 0.999
