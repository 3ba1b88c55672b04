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
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

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


def _group(P, shape=(2, 6, 10), seed=3):
    gt, _, mask = _depth_pair(shape, seed)
    rng = np.random.default_rng(seed + 1)
    preds = [torch.from_numpy(gt * rng.uniform(0.7, 1.4, shape).astype(np.float32))
             for _ in range(P)]
    return preds, torch.from_numpy(gt), torch.from_numpy(mask)


def _refused_group(kind):
    """A group of the kind the grouped entries refuse, on the CPU; the
    refusal's message."""
    preds, gt, mask = _group(4)
    weights = [1.0, 0.5, 0.25, 0.125]
    if kind == "cpu tensors":
        return (preds, gt, mask, weights), "CUDA tensor"
    if kind == "shape mismatch":
        return (preds[:3] + [preds[3][:, 1:]], gt, mask, weights), r"pred 3 shape"
    if kind == "mask shape mismatch":
        return (preds, gt, mask[:1], weights), "mask shape"
    if kind == "9 predictions":
        return (preds * 2 + preds[:1], gt, mask, [1.0] * 9), "1 to 8 predictions"
    if kind == "no prediction":
        return ([], gt, mask, []), "1 to 8 predictions"
    return (preds, gt, mask, weights[:3]), "4 predictions but 3 weights"


@pytest.mark.parametrize("entry", ["forward_many", "backward_many", "loss_many"])
@pytest.mark.parametrize("kind", ["cpu tensors", "shape mismatch", "mask shape mismatch",
                                  "9 predictions", "no prediction", "weights mismatch"])
def test_grouped_berhu_entries_refuse_what_the_kernels_do_not_take(entry, kind):
    """Each refusal is a ValueError raised before any launch: no counter
    moves."""
    (preds, gt, mask, weights), message = _refused_group(kind)
    calls = {
        "forward_many": lambda: kl.berhu_forward_many(preds, gt, mask, weights),
        "backward_many": lambda: kl.berhu_backward_many(
            preds, gt, mask, torch.zeros(3 * len(preds)), weights, torch.ones(())),
        "loss_many": lambda: kl.berhu_loss_many_cuda(preds, gt, mask, weights),
    }
    counters = (kl.berhu_fwd_launches, kl.berhu_bwd_launches, kl.berhu_fwd_problems)
    with pytest.raises(ValueError, match=message):
        calls[entry]()
    assert (kl.berhu_fwd_launches, kl.berhu_bwd_launches, kl.berhu_fwd_problems) == counters


def test_grouped_berhu_table_is_packed_in_the_kernels_layout():
    """``BerhuTable``: 8 prediction pointers, 8 gradient pointers, 8 float32
    weights, unused rows zero; 160 bytes."""
    preds, _, _ = _group(3)
    dpreds = [torch.empty_like(p) for p in preds]
    fields = kl._TABLE.unpack(kl._table(preds, dpreds, [1.0, 0.5, 0.1]))
    assert kl._TABLE.size == 160 and kl.MAX_PROBLEMS == 8
    assert fields[:8] == (*(p.data_ptr() for p in preds), 0, 0, 0, 0, 0)
    assert fields[8:16] == (*(d.data_ptr() for d in dpreds), 0, 0, 0, 0, 0)
    assert fields[16:] == (1.0, 0.5, float(np.float32(0.1)), 0.0, 0.0, 0.0, 0.0, 0.0)
    assert kl._table(preds, (), [1.0, 0.5, 0.1])[64:128] == bytes(64)


@pytest.mark.parametrize("loss_fn,device_type,grouped", [
    ("berhu_loss", "cuda", True),
    ("berhu_loss", "cpu", False),
    ("berhu_loss_plain", "cuda", False),
    ("l1_loss", "cuda", False),
    ("scale_invariant_loss", "cuda", False),
])
def test_grouped_route_takes_cuda_berhu_only(loss_fn, device_type, grouped):
    """The route of ``multiscale_supervised_loss``, handed the device type:
    the grouped kernels for the kernel-backed BerHu on CUDA tensors, the
    per-scale loop for every other loss (the plain BerHu included) or
    device."""
    route = sup.grouped_route(getattr(sup, loss_fn), device_type)
    assert route is (kl.berhu_loss_many_cuda if grouped else None)


def _per_scale_loop(preds, gt, mask, loss_fn, weights=(1.0, 0.5, 0.25, 0.125)):
    """The multi-scale loss as the per-scale loop computes it."""
    H, W = gt.shape[1], gt.shape[2]
    total = torch.zeros((), dtype=torch.float32)
    for pred, w in zip(preds, weights):
        up = torch.nn.functional.interpolate(pred[:, None], size=(H, W), mode="bilinear",
                                             align_corners=False) if pred.shape[1:] != (H, W) \
            else pred[:, None]
        total = total + w * loss_fn(up[:, 0].contiguous(), gt, mask)
    return total


def _scales(B=2, H=32, W=48, seed=12):
    rng = np.random.default_rng(seed)
    gt = torch.from_numpy(rng.uniform(1.0, 60.0, (B, H, W)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=(B, H, W)) > 0.5)
    preds = [torch.from_numpy(rng.uniform(1.0, 60.0, (B, H >> s, W >> s)).astype(np.float32))
             for s in range(4)]
    return preds, gt, mask


def test_multiscale_berhu_on_the_cpu_is_the_per_scale_loop_bit_for_bit():
    """On the CPU the multi-scale BerHu stays the per-scale loop of the
    plain version: value and every scale's gradient equal bit for bit, and
    no kernel counter moves."""
    preds, gt, mask = _scales()
    counters = (kl.berhu_fwd_launches, kl.berhu_bwd_launches, kl.berhu_fwd_problems)
    ps = [p.clone().requires_grad_(True) for p in preds]
    loss = sup.multiscale_supervised_loss(ps, gt, mask, sup.berhu_loss)
    grads = torch.autograd.grad(loss, ps)
    qs = [p.clone().requires_grad_(True) for p in preds]
    ref = _per_scale_loop(qs, gt, mask, sup.berhu_loss_plain)
    ref_grads = torch.autograd.grad(ref, qs)
    assert torch.equal(loss, ref)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
    assert (kl.berhu_fwd_launches, kl.berhu_bwd_launches, kl.berhu_fwd_problems) == counters


def test_multiscale_loss_hands_the_upsampled_scales_to_the_grouped_entry(monkeypatch):
    """With the route pointing BerHu at a counting substitute (as it does
    on the card), ``multiscale_supervised_loss`` upsamples every scale
    first and makes one grouped call with the four (B, H, W) contiguous
    predictions and the weights; its result is the call's."""
    calls = []

    def grouped(ups, gt, mask, weights):
        calls.append(([tuple(u.shape) for u in ups], [u.is_contiguous() for u in ups],
                      list(weights)))
        total = torch.zeros((), dtype=torch.float32)
        for u, w in zip(ups, weights):
            total = total + w * sup.berhu_loss_plain(u, gt, mask)
        return total

    monkeypatch.setattr(sup, "grouped_route",
                        lambda fn, device_type: grouped if fn is sup.berhu_loss else None)
    preds, gt, mask = _scales()
    ps = [p.clone().requires_grad_(True) for p in preds]
    loss = sup.multiscale_supervised_loss(ps, gt, mask, sup.berhu_loss)
    qs = [p.clone().requires_grad_(True) for p in preds]
    ref = _per_scale_loop(qs, gt, mask, sup.berhu_loss_plain)
    assert calls == [([(2, 32, 48)] * 4, [True] * 4, [1.0, 0.5, 0.25, 0.125])]
    assert torch.equal(loss, ref)
    assert all(torch.equal(a, b) for a, b in zip(torch.autograd.grad(loss, ps),
                                                  torch.autograd.grad(ref, qs)))
    sup.multiscale_supervised_loss(preds, gt, mask, sup.l1_loss)
    assert len(calls) == 1
