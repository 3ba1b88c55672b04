"""The port's supervised losses against the JAX package's, on the CPU: the
plain BerHu against the XLA loss and the interpret-mode Pallas kernel (value
and pred-gradient), L1 and scale-invariant, and the multi-scale loss.
Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.losses import supervised as jax_sup
from supervised_dispnet_tpu.ops.pallas import berhu_loss_pallas
from supervised_dispnet_tpu_torch.losses import supervised as sup
from supervised_dispnet_tpu_torch.ops.cuda import losses as kl

JAX_BERHU = {
    "xla": jax_sup.berhu_loss,
    "pallas": lambda p, g, m: berhu_loss_pallas(p, g, m, interpret=True),
}


def _depth_pair(shape, seed, mask_kind="sparse"):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(1.0, 60.0, shape).astype(np.float32)
    pred = gt * rng.uniform(0.7, 1.4, shape).astype(np.float32)
    mask = (rng.uniform(size=shape) > 0.6) if mask_kind == "sparse" else np.zeros(shape, bool)
    return gt, pred, mask


@pytest.mark.parametrize("impl", sorted(JAX_BERHU))
@pytest.mark.parametrize("shape,mask_kind", [((2, 24, 40), "sparse"),
                                             ((3, 37, 53), "sparse"),
                                             ((2, 24, 40), "empty")])
def test_berhu_plain_matches_jax(impl, shape, mask_kind):
    """Value and pred-gradient, rtol 1e-5 / atol 1e-6 (summation order);
    a CPU tensor takes the plain version and never launches the kernel."""
    gt, pred, mask = _depth_pair(shape, seed=sum(shape), mask_kind=mask_kind)
    ref_loss, ref_grad = jax.value_and_grad(JAX_BERHU[impl])(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask))
    launches = (kl.berhu_fwd_launches, kl.berhu_bwd_launches)
    p = torch.from_numpy(pred).requires_grad_(True)
    loss = sup.berhu_loss(p, torch.from_numpy(gt), torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-6)
    assert (kl.berhu_fwd_launches, kl.berhu_bwd_launches) == launches
    if mask_kind == "empty":
        assert loss.item() == 0.0 and not p.grad.any()


def test_berhu_plain_fractional_mask_matches_jax_xla():
    """A float mask with weights in (0, 1): the mask scales d and weighs the
    sum, so the gradient carries it squared (the Pallas op takes 0/1 masks)."""
    gt, pred, mask = _depth_pair((2, 24, 40), seed=5)
    w = (mask * np.random.default_rng(6).uniform(0.05, 1.0, mask.shape)).astype(np.float32)
    ref_loss, ref_grad = jax.value_and_grad(jax_sup.berhu_loss)(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(w))
    p = torch.from_numpy(pred).requires_grad_(True)
    loss = sup.berhu_loss(p, torch.from_numpy(gt), torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-6)


def test_berhu_kernel_wrapper_takes_cuda_tensors_only():
    gt, pred, mask = (torch.from_numpy(a) for a in _depth_pair((1, 4, 5), seed=0))
    launches = (kl.berhu_fwd_launches, kl.berhu_bwd_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kl.berhu_loss_cuda(pred, gt, mask)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kl.berhu_forward_stats(pred, gt, mask)
    assert (kl.berhu_fwd_launches, kl.berhu_bwd_launches) == launches


@pytest.mark.parametrize("name", ["l1_loss", "scale_invariant_loss"])
def test_other_supervised_losses_match_jax(name):
    gt, pred, mask = _depth_pair((2, 24, 40), seed=7)
    ref_loss, ref_grad = jax.value_and_grad(getattr(jax_sup, name))(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask))
    p = torch.from_numpy(pred).requires_grad_(True)
    loss = getattr(sup, name)(p, torch.from_numpy(gt), torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["berhu_loss", "l1_loss", "scale_invariant_loss"])
def test_multiscale_supervised_loss_matches_jax(name):
    """Four scales (1, 1/2, 1/4, 1/8), each upsampled to GT size, weights
    (1, .5, .25, .125); value and the gradient of every scale."""
    B, H, W = 2, 32, 48
    rng = np.random.default_rng(11)
    gt = rng.uniform(1.0, 60.0, (B, H, W)).astype(np.float32)
    mask = rng.uniform(size=(B, H, W)) > 0.5
    preds = [rng.uniform(1.0, 60.0, (B, H >> s, W >> s)).astype(np.float32)
             for s in range(4)]
    ref_loss, ref_grads = jax.value_and_grad(
        lambda ps: jax_sup.multiscale_supervised_loss(
            ps, jnp.asarray(gt), jnp.asarray(mask), getattr(jax_sup, name)))(
        [jnp.asarray(p) for p in preds])
    ps = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    loss = sup.multiscale_supervised_loss(ps, torch.from_numpy(gt),
                                          torch.from_numpy(mask), getattr(sup, name))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5, atol=1e-6)
    for p, g in zip(ps, ref_grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-6)
