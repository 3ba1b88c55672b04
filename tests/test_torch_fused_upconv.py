"""The port's fused decoder stage (``ops/fused_upconv.py``) and
``DispResNet(fused_upsample=True)``.

The op against JAX's ``upconv2x_fused`` (NHWC / HWIO, HIGHEST precision)
and against the port's own upsample -> conv, forward and gradients with
respect to the input and the kernel: rtol 1e-5 / atol 1e-5, the standard
JAX's own tests hold the op to (a reordering of the same float32
contractions). The inputs are non-square with Cin != Cout, so a swap of
the phases' row and column parity shows.

The model against the unfused port model (same weights) and against JAX's
fused DispResNet-18 in eval mode at 64x96, weights carried by
``dispresnet_from_jax``: rtol 1e-3 / atol 2e-4, as
``tests/test_checkpoint_convert.py`` sets them for disparity nets; the
gradients of a weighted sum of the four disparities with respect to every
parameter, in eval mode against JAX's and in train mode against the
unfused port model's, rtol 1e-3 of each parameter's largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from supervised_dispnet_tpu.models import DispResNet as JaxDispResNet
from supervised_dispnet_tpu.ops.fused_upconv import upconv2x_fused as jax_upconv2x_fused
from supervised_dispnet_tpu_torch.models import DispResNet, get_disp_net
from supervised_dispnet_tpu_torch.ops.fused_upconv import upconv2x_fused
from supervised_dispnet_tpu_torch.ops.resize import interpolate_bilinear
from supervised_dispnet_tpu_torch.utils.convert import dispresnet_from_jax
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

HP = jax.lax.Precision.HIGHEST


def _unfused(x, w):
    H, W = x.shape[-2:]
    return F.conv2d(interpolate_bilinear(x, 2 * H, 2 * W), w, padding=1)


@jax.jit
def _jax_op_and_grads(x, k, g):
    """JAX's op and the gradients of sum(op * g) with respect to x and k."""
    out, vjp = jax.vjp(lambda x, k: jax_upconv2x_fused(x, k, precision=HP), x, k)
    return (out, *vjp(g))


@pytest.mark.parametrize("shape,cout", [
    ((2, 3, 6, 8), 4),
    ((1, 16, 4, 13), 7),  # odd width
    ((3, 2, 5, 9), 1),
    ((1, 5, 1, 3), 2),  # one row: top and bottom corrections on the same rows
])
def test_upconv2x_fused_matches_jax_and_upsample_conv(shape, cout):
    rng = np.random.default_rng(sum(shape) + cout)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(cout, shape[1], 3, 3)).astype(np.float32)
    B, _, H, W = shape
    g = rng.normal(size=(B, cout, 2 * H, 2 * W)).astype(np.float32)

    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = upconv2x_fused(xt, wt)
    dx, dw = torch.autograd.grad((out * torch.tensor(g)).sum(), (xt, wt))

    xr = torch.tensor(x, requires_grad=True)
    wr = torch.tensor(w, requires_grad=True)
    ref = _unfused(xr, wr)
    rdx, rdw = torch.autograd.grad((ref * torch.tensor(g)).sum(), (xr, wr))

    # JAX: NHWC / HWIO
    xj, kj, gj = x.transpose(0, 2, 3, 1), w.transpose(2, 3, 1, 0), g.transpose(0, 2, 3, 1)
    jout, jdx, jdk = _jax_op_and_grads(jnp.asarray(xj), jnp.asarray(kj), jnp.asarray(gj))

    tol = dict(rtol=1e-5, atol=1e-5)
    assert out.shape == (B, cout, 2 * H, 2 * W)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), **tol)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout).transpose(0, 3, 1, 2),
                               **tol)
    np.testing.assert_allclose(dx.numpy(), rdx.numpy(), **tol)
    np.testing.assert_allclose(dw.numpy(), rdw.numpy(), **tol)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx).transpose(0, 3, 1, 2), **tol)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdk).transpose(3, 2, 0, 1), **tol)


def _randomize(tree, rng):
    """BN scale, bias and running statistics away from their init."""
    def leaf(path, x):
        name = str(path[-1])
        if "var" in name or "scale" in name:
            return rng.uniform(0.5, 1.5, np.shape(x)).astype(np.float32)
        if "mean" in name or "bias" in name:
            return (0.1 * rng.standard_normal(np.shape(x))).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _weights(outs):
    """A fixed weight map for each output, so that every pixel's gradient
    differs."""
    return [np.linspace(0, 1, np.prod(o.shape), dtype=np.float32).reshape(o.shape)
            for o in outs]


def _port_loss(outs):
    return sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, _weights(outs)))


def _assert_grads_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, r in want.items():
        r = np.asarray(r)
        np.testing.assert_allclose(np.asarray(got[name]), r, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(r).max()), err_msg=name)


@pytest.fixture(scope="module")
def jax_fused_model():
    """JAX's fused DispResNet-18 at (2, 64, 96) in eval mode: its randomised
    weights, an input, the four disparities and the gradients of their
    weighted sum with respect to ``params``."""
    model = JaxDispResNet(encoder_depth=18, fused_upsample=True)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros_like(x))
    rng = np.random.default_rng(0)
    params = _randomize(jax.device_get(v["params"]), rng)
    stats = _randomize(jax.device_get(v["batch_stats"]), rng)

    @jax.jit
    def run(p):
        def loss(p):
            outs = model.apply({"params": p, "batch_stats": stats}, x, train=False)
            return sum(jnp.sum(o * w) for o, w in zip(outs, _weights(outs))), outs
        return jax.grad(loss, has_aux=True)(p)

    grads, outs = run(params)
    return params, stats, x, [np.asarray(o) for o in outs], jax.device_get(grads)


def test_fused_dispresnet_matches_jax_and_the_unfused_port(jax_fused_model):
    params, stats, x, want, jax_grads = jax_fused_model
    sd = dispresnet_from_jax(params, stats, 18)
    fused = DispResNet(18, fused_upsample=True)
    fused.load_state_dict(sd, strict=True)
    unfused = DispResNet(18)
    unfused.load_state_dict(fused.state_dict(), strict=True)
    with torch.no_grad():
        plain = unfused.eval()(torch.tensor(x))
    got = fused.eval()(torch.tensor(x))
    assert len(got) == len(want) == 4
    for g, p, w in zip(got, plain, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-3, atol=2e-4)
        np.testing.assert_allclose(g.detach().numpy(), p.numpy(), rtol=1e-3, atol=2e-4)

    names = [n for n, _ in fused.named_parameters()]
    grads = torch.autograd.grad(_port_loss(got), list(fused.parameters()))
    want_grads = dispresnet_from_jax(jax_grads, stats, 18)
    _assert_grads_close(dict(zip(names, grads)), {n: want_grads[n] for n in names})


@pytest.mark.parametrize("head", ["disp", "classification"])
def test_fused_dispresnet_gradients_match_the_unfused_port(head):
    """One train-mode forward and backward of a weighted sum of every
    output: each parameter's gradient fused against unfused."""
    fused = get_disp_net("disp_res_18", head=head, num_bins=8, fused_upsample=True,
                         seed=2, device="cpu")
    unfused = get_disp_net("disp_res_18", head=head, num_bins=8, seed=2, device="cpu")
    x = torch.tensor(np.random.default_rng(6).uniform(-1, 1, (2, 64, 96, 3)),
                     dtype=torch.float32)
    grads = []
    for model in (fused, unfused):
        out = model(x)
        grads.append({n: g.numpy() for (n, _), g in zip(
            model.named_parameters(),
            torch.autograd.grad(_port_loss(out if isinstance(out, list) else [out]),
                                list(model.parameters())))})
    _assert_grads_close(*grads)


def test_fused_geometry_must_be_exact_2x():
    model = DispResNet(18, fused_upsample=True).eval()
    with pytest.raises(ValueError, match="divisible by 32"):
        with torch.no_grad():
            model(torch.zeros(1, 48, 96, 3))
    with pytest.raises(ValueError, match="disp_res"):
        get_disp_net("dispnet", fused_upsample=True, device="cpu")


def test_cached_taps_survive_a_first_call_under_inference_mode():
    """The tent taps are cached a device and dtype. A process whose first
    fused forward runs under ``torch.inference_mode()`` (the eval CLIs, a
    serving process) and later trains must get taps that autograd may save:
    a fused DispResNet forward and backward after it runs, with finite
    gradients (their values: ``test_fused_dispresnet_gradients_match_the_
    unfused_port``)."""
    from supervised_dispnet_tpu_torch.ops import fused_upconv

    fused_upconv._tent.cache_clear()
    fused = get_disp_net("disp_res_18", fused_upsample=True, seed=3, device="cpu")
    x = torch.tensor(np.random.default_rng(7).uniform(-1, 1, (1, 32, 64, 3)),
                     dtype=torch.float32)
    with torch.inference_mode():
        fused.eval()(x)
    assert not any(t.is_inference() for t in (
        fused_upconv._tent(n, torch.device("cpu"), torch.float32) for n in (1, 2)))
    grads = torch.autograd.grad(_port_loss(fused.train()(x)), list(fused.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
