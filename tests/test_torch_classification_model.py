"""The port's DispResNet classification head against the JAX package's, on
the CPU in fp32: the forward (single- and multi-scale), the converter
(key for key against the JAX exporter, as the inverse of the JAX importer)
and the reference layout (``tests/torch_ref.py``). DispResNet-18, 16 bins,
64x96. Tolerances as ``test_torch_models.py``: rtol 1e-3 / atol 2e-4
(BN and 18 layers; the logits are unbounded, unlike a sigmoid disparity)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.models import DispResNet as JaxDispResNet
from supervised_dispnet_tpu.utils.convert_models import (
    convert_dispresnet, export_dispresnet_to_torch)
from supervised_dispnet_tpu_torch.models import DispNetS, DispResNet, get_disp_net
from supervised_dispnet_tpu_torch.utils.convert import dispresnet_from_jax
from tests.torch_ref import TorchDispResNet
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

DEPTH, K, B, H, W = 18, 16, 2, 64, 96
CLS = {"head": "classification", "num_bins": K}


def _perturb(tree, rng):
    """BN scale / bias / stats away from their 1/0 init, conv biases away
    from 0, so both are exercised."""
    def leaf(path, x):
        x = np.asarray(x)
        name = str(path[-1])
        if "var" in name or "scale" in name:
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if "mean" in name or "bias" in name:
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module", params=[False, True], ids=["single", "multiscale"])
def jax_model(request):
    multi = request.param
    model = JaxDispResNet(encoder_depth=DEPTH, multiscale_classification=multi, **CLS)
    v = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((B, H, W, 3))))
    rng = np.random.default_rng(1)
    return model, _perturb(v["params"], rng), _perturb(v["batch_stats"], rng), multi


def test_classification_head_forward_matches_jax(jax_model):
    """Eval-mode logits: (B, H, W, K), or four of them finest first
    (B, H/2^s, W/2^s, K); each the NHWC view of the conv's NCHW output."""
    model, params, stats, multi = jax_model
    x = np.random.default_rng(2).standard_normal((B, H, W, 3)).astype(np.float32)
    ref = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    port = DispResNet(DEPTH, multiscale_classification=multi, **CLS).eval()
    port.load_state_dict(dispresnet_from_jax(params, stats, DEPTH, "classification", multi),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    if not multi:
        got, ref = [got], [ref]
    assert len(got) == (4 if multi else 1)
    for s, (g, r) in enumerate(zip(got, ref)):
        assert tuple(g.shape) == r.shape == (B, H >> s, W >> s, K)
        assert g.permute(0, 3, 1, 2).is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3, atol=2e-4)


def test_classification_converter_matches_exporter_key_for_key():
    """Single-scale: the same names in the same order and the same values
    as the JAX package's ``export_dispresnet_to_torch(head=...)``."""
    model = JaxDispResNet(encoder_depth=DEPTH, **CLS)
    v = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3))))
    ref = export_dispresnet_to_torch(v["params"], v["batch_stats"], depth=DEPTH,
                                     head="classification")
    got = dispresnet_from_jax(v["params"], v["batch_stats"], DEPTH, head="classification")
    assert list(got) == list(ref)
    assert list(got)[-2:] == ["predict_class.0.weight", "predict_class.0.bias"]
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    DispResNet(DEPTH, **CLS).load_state_dict(got, strict=True)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multiscale"])
def test_classification_converter_inverts_the_jax_importer(multi):
    """The port's state dict through the JAX package's ``convert_dispresnet``
    and back through ``dispresnet_from_jax`` comes out unchanged; the
    multi-scale heads are ``predict_class{2,3,4}.0``."""
    torch.manual_seed(0)
    port = DispResNet(DEPTH, multiscale_classification=multi, **CLS)
    sd = {k: v.detach() for k, v in port.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    heads = sorted({k.rsplit(".", 2)[0] for k in sd if k.startswith("predict_")})
    assert heads == (["predict_class", "predict_class2", "predict_class3", "predict_class4"]
                     if multi else ["predict_class"])
    params, stats = convert_dispresnet(sd, depth=DEPTH, head="classification",
                                       multiscale_classification=multi)
    got = dispresnet_from_jax(params, stats, DEPTH, "classification", multi)
    assert set(got) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k].numpy(), sd[k].numpy(), err_msg=k)


def test_classification_head_loads_the_reference_layout():
    """``TorchDispResNet(head='classification')`` and the port load each
    other's state dicts strictly and give the same eval logits."""
    torch.manual_seed(1)
    ref = TorchDispResNet(depth=DEPTH, **CLS).eval()
    port = DispResNet(DEPTH, **CLS).eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    ref.load_state_dict(port.state_dict(), strict=True)
    x = torch.randn(1, H, W, 3)
    with torch.no_grad():
        a, b = port(x), ref(x.permute(0, 3, 1, 2))
    np.testing.assert_allclose(a.numpy(), b.permute(0, 2, 3, 1).numpy(), rtol=1e-5, atol=1e-5)


def test_registry_builds_the_classification_head():
    model = get_disp_net("disp_res_18", head="classification", num_bins=K,
                         multiscale_classification=True, device="cpu")
    assert isinstance(model, DispResNet) and model.predict_class4[0].out_channels == K
    assert isinstance(get_disp_net("dispnet", device="cpu"), DispNetS)
    with pytest.raises(ValueError, match="disp_res"):
        get_disp_net("dispnet", head="classification", device="cpu")
    with pytest.raises(ValueError, match="head"):
        DispResNet(DEPTH, head="bins")
