"""The port's DispResNet against the JAX package's, on the CPU in fp32, with
weights carried across by ``utils/convert.py::dispresnet_from_jax``.
Tolerances follow ``test_checkpoint_convert.py``: rtol 1e-3 / atol 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.models import DispResNet as JaxDispResNet
from supervised_dispnet_tpu.ops.resize import resize_bilinear as jax_resize
from supervised_dispnet_tpu.utils.convert_models import export_dispresnet_to_torch
from supervised_dispnet_tpu_torch.models import DispResNet
from supervised_dispnet_tpu_torch.ops.resize import resize_bilinear
from supervised_dispnet_tpu_torch.utils.convert import dispresnet_from_jax
from tests.torch_ref import TorchDispResNet


def _randomize(tree, rng, positive=False):
    """Perturb every leaf (BN scale/bias and running stats away from their
    1/0 init, so BN is exercised)."""
    def leaf(path, x):
        x = np.asarray(x)
        name = str(path[-1])
        if "var" in name:
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if "mean" in name or "bias" in name:
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if "scale" in name:
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _jax_model(depth, B, H, W, seed=0):
    model = JaxDispResNet(encoder_depth=depth)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((B, H, W, 3)))
    rng = np.random.default_rng(seed)
    params = _randomize(jax.device_get(v["params"]), rng)
    stats = _randomize(jax.device_get(v["batch_stats"]), rng)
    return model, params, stats


def _port_model(params, stats, depth):
    model = DispResNet(depth)
    model.load_state_dict(dispresnet_from_jax(params, stats, depth), strict=True)
    return model


@pytest.mark.parametrize("depth", [18, 50])
def test_convert_matches_exporter_key_for_key(depth):
    model = JaxDispResNet(encoder_depth=depth)
    v = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3))))
    ref = export_dispresnet_to_torch(v["params"], v["batch_stats"], depth=depth)
    got = dispresnet_from_jax(v["params"], v["batch_stats"], depth)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    port = DispResNet(depth)
    port.load_state_dict(got, strict=True)
    assert {k for k in port.state_dict() if not k.endswith("num_batches_tracked")} == set(ref)


@pytest.mark.parametrize("depth,B,H,W", [(18, 2, 64, 96), (50, 1, 64, 64)])
def test_eval_forward_matches_jax(depth, B, H, W):
    jmodel, params, stats = _jax_model(depth, B, H, W)
    x = np.random.default_rng(3).standard_normal((B, H, W, 3)).astype(np.float32)
    ref = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    model = _port_model(params, stats, depth).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == 4
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3, atol=2e-4)


def test_train_forward_updates_bn_stats_like_flax():
    """Train-mode forward: same outputs and the same updated running stats.
    flax updates var with the biased batch variance, torch's BatchNorm2d with
    the unbiased one; at the 1/32 level of a 64x96 input (n = 2*2*3 = 12)
    the two differ by 12/11."""
    depth, B, H, W = 18, 2, 64, 96
    jmodel, params, stats = _jax_model(depth, B, H, W, seed=4)
    x = np.random.default_rng(5).standard_normal((B, H, W, 3)).astype(np.float32)
    ref, upd = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                            train=True, mutable=["batch_stats"])
    model = _port_model(params, stats, depth).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3, atol=2e-4)
    ref_sd = dispresnet_from_jax(params, jax.device_get(upd["batch_stats"]), depth)
    sd = model.state_dict()
    keys = [k for k in ref_sd if "running_" in k]
    assert keys
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), ref_sd[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_state_dict_interchanges_with_reference_layout():
    """The port loads the reference layout's state dict (with
    ``num_batches_tracked``) strictly, and the reference loads the port's;
    both give the same eval forward."""
    torch.manual_seed(0)
    ref = TorchDispResNet(depth=18).eval()
    port = DispResNet(18).eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    ref.load_state_dict(port.state_dict(), strict=True)
    x = torch.randn(1, 64, 96, 3)
    with torch.no_grad():
        a = port(x)
        b = ref(x.permute(0, 3, 1, 2))
    for g, r in zip(a, b):
        np.testing.assert_allclose(g.numpy(), r.permute(0, 2, 3, 1).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((4, 6), (8, 12)), ((16, 52), (128, 416)),
                                     ((5, 7), (13, 9))])
def test_resize_bilinear_upsampling_matches_jax(src, dst):
    x = np.random.default_rng(6).standard_normal((2, *src, 3)).astype(np.float32)
    ref = jax_resize(jnp.asarray(x), *dst)
    got = resize_bilinear(torch.from_numpy(x), *dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_resize_bilinear_refuses_downsampling():
    with pytest.raises(NotImplementedError, match="antialias"):
        resize_bilinear(torch.zeros(1, 8, 8, 1), 4, 8)


@pytest.mark.parametrize("kw", [{"head": "classification"}, {"fused_upsample": True}])
def test_unported_variants_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DispResNet(18, **kw)
