"""The port's models against the JAX package's, on the CPU in fp32, with
weights carried across by ``utils/convert.py``. DispResNet: tolerances
follow ``test_checkpoint_convert.py``, rtol 1e-3 / atol 2e-4 (train-mode BN
and 50 layers). DispNetS and PoseExpNet (conv + ELU, no BN): rtol 1e-4 /
atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.models import DispNetS as JaxDispNetS
from supervised_dispnet_tpu.models import DispResNet as JaxDispResNet
from supervised_dispnet_tpu.models import PoseExpNet as JaxPoseExpNet
from supervised_dispnet_tpu.models import PoseNet as JaxPoseNet
from supervised_dispnet_tpu.utils.checkpoint import convert_dispnet, convert_pose_exp_net
from supervised_dispnet_tpu.ops.resize import resize_bilinear as jax_resize
from supervised_dispnet_tpu.utils.convert_models import export_dispresnet_to_torch
from supervised_dispnet_tpu_torch.models import (
    DispNetS, DispResNet, PoseExpNet, PoseNet, get_disp_net)
from supervised_dispnet_tpu_torch.ops.resize import downsample2x_avg, resize_bilinear
from supervised_dispnet_tpu_torch.utils.convert import (
    dispnet_from_jax, dispresnet_from_jax, posexpnet_from_jax)
from tests.torch_ref import TorchDispNetS, TorchDispResNet, TorchPoseExpNet
from tests.torch_threads import cap_torch_threads

cap_torch_threads()


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


@pytest.mark.parametrize("kw", [{"name": "fcrn", "remat": "half"}])
def test_unported_variants_raise(kw):
    """A remat policy the JAX factory does not have raises, naming the
    choices ("full" and "conv" are ported)."""
    with pytest.raises(ValueError, match="'full', 'conv'"):
        get_disp_net(**kw, device="cpu")


def _perturb_biases(tree, rng):
    """flax inits biases at 0; perturb them so the converters' bias mapping
    is exercised."""
    def leaf(path, x):
        x = np.asarray(x)
        if str(path[-1]).endswith("bias']"):
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


# (B, H, W): 64x96 and a size that is odd at several encoder levels
SELFSUP_SHAPES = [(2, 64, 96), (1, 36, 52)]


@pytest.mark.parametrize("B,H,W", SELFSUP_SHAPES)
def test_dispnet_forward_matches_jax(B, H, W):
    jmodel = JaxDispNetS()
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((B, H, W, 3)))
    params = _perturb_biases(jax.device_get(v["params"]), np.random.default_rng(0))
    x = np.random.default_rng(1).standard_normal((B, H, W, 3)).astype(np.float32)
    ref = jmodel.apply({"params": params}, jnp.asarray(x))
    model = DispNetS()
    model.load_state_dict(dispnet_from_jax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == 4
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("B,H,W", SELFSUP_SHAPES)
@pytest.mark.parametrize("output_exp", [True, False])
def test_posexpnet_forward_matches_jax(B, H, W, output_exp):
    jmodel = JaxPoseExpNet(nb_ref_imgs=2, output_exp=output_exp)
    rng = np.random.default_rng(2)
    tgt, r1, r2 = (rng.standard_normal((B, H, W, 3)).astype(np.float32) for _ in range(3))
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(tgt),
                             [jnp.asarray(r1), jnp.asarray(r2)])
    params = _perturb_biases(jax.device_get(v["params"]), rng)
    ref_masks, ref_pose = jmodel.apply({"params": params}, jnp.asarray(tgt),
                                       [jnp.asarray(r1), jnp.asarray(r2)])
    model = PoseExpNet(nb_ref_imgs=2, output_exp=output_exp)
    model.load_state_dict(posexpnet_from_jax(params, output_exp), strict=True)
    with torch.no_grad():
        masks, pose = model(torch.from_numpy(tgt), [torch.from_numpy(r1), torch.from_numpy(r2)])
    assert tuple(pose.shape) == (B, 2, 6)
    np.testing.assert_allclose(pose.numpy(), np.asarray(ref_pose), rtol=1e-4, atol=1e-7)
    if not output_exp:
        assert masks is None and ref_masks is None
        return
    for g, r in zip(masks, ref_masks):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


def test_posenet_matches_jax():
    jmodel = JaxPoseNet(nb_ref_imgs=2)
    rng = np.random.default_rng(3)
    imgs = [rng.standard_normal((1, 64, 96, 3)).astype(np.float32) for _ in range(3)]
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.asarray(imgs[0]),
                             [jnp.asarray(i) for i in imgs[1:]])
    params = _perturb_biases(jax.device_get(v["params"]), rng)
    ref = jmodel.apply({"params": params}, jnp.asarray(imgs[0]),
                       [jnp.asarray(i) for i in imgs[1:]])
    model = PoseNet(nb_ref_imgs=2)
    model.load_state_dict(posexpnet_from_jax(params["PoseExpNet_0"], output_exp=False),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(imgs[0]), [torch.from_numpy(i) for i in imgs[1:]])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-7)


def test_selfsup_converters_invert_the_jax_package_converters():
    """Reference-layout state dicts (``tests/torch_ref.py``) through the JAX
    package's ``convert_dispnet`` / ``convert_pose_exp_net`` and back through
    the port's converters come out unchanged, transposed-conv kernels
    included; both load ``strict=True`` into the reference modules."""
    torch.manual_seed(0)
    for ref, to_jax, back in (
            (TorchDispNetS(), convert_dispnet, dispnet_from_jax),
            (TorchPoseExpNet(nb_ref_imgs=2), convert_pose_exp_net, posexpnet_from_jax)):
        sd = {k: v.detach() for k, v in ref.state_dict().items()}
        got = back(to_jax(sd))
        assert set(got) == set(sd)
        for k in sd:
            np.testing.assert_array_equal(got[k].numpy(), sd[k].numpy(), err_msg=k)
        ref.load_state_dict(got, strict=True)


@pytest.mark.parametrize("B,H,W", [(2, 64, 128)])
def test_selfsup_models_interchange_with_reference_layout(B, H, W):
    """The port loads the reference modules' state dicts strictly and gives
    their forward (a size where the reference's 2x decoder resize equals the
    JAX package's resize to the skip's size)."""
    torch.manual_seed(1)
    x = torch.randn(B, H, W, 3)
    refs = [torch.randn(B, H, W, 3) for _ in range(2)]
    ref_d, port_d = TorchDispNetS().eval(), DispNetS().eval()
    port_d.load_state_dict(ref_d.state_dict(), strict=True)
    ref_p, port_p = TorchPoseExpNet(nb_ref_imgs=2).eval(), PoseExpNet(nb_ref_imgs=2).eval()
    port_p.load_state_dict(ref_p.state_dict(), strict=True)
    with torch.no_grad():
        a, b = port_d(x), ref_d(x.permute(0, 3, 1, 2))
        (ma, pa), (mb, pb) = (port_p(x, refs),
                              ref_p(x.permute(0, 3, 1, 2), [r.permute(0, 3, 1, 2) for r in refs]))
    for g, r in zip(a, b):
        np.testing.assert_allclose(g.numpy(), r.permute(0, 2, 3, 1).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pa.numpy(), pb.numpy(), rtol=1e-5, atol=1e-7)
    for g, r in zip(ma, mb):
        np.testing.assert_allclose(g.numpy(), r.permute(0, 2, 3, 1).numpy(), rtol=1e-5, atol=1e-6)


def test_registry_serves_dispnet():
    """The registry's DispNetS served in int8: without calibration images
    the service refuses it, as JAX's does; with them it serves the int8
    twin (``tests/test_torch_int8_serving.py`` holds it against JAX's)."""
    from supervised_dispnet_tpu_torch.ops.quant import QuantizedModel
    from supervised_dispnet_tpu_torch.serving import DepthService, ServingConfig

    model = get_disp_net("dispnet", device="cpu")
    assert isinstance(model, DispNetS)
    cfg = ServingConfig(img_height=32, img_width=64, buckets=(1,), int8=True)
    with pytest.raises(ValueError, match="calibration"):
        DepthService(model, cfg, device="cpu")
    calib = [np.random.default_rng(0).integers(0, 256, (32, 64, 3), dtype=np.uint8)]
    svc = DepthService(model, cfg, device="cpu", calibration=calib)
    assert isinstance(svc._net, QuantizedModel) and svc.predict(calib[0]).shape == (1, 32, 64)


def test_registry_refuses_fused_upsample_on_dispnet():
    """DispNetS has no resize->conv decoder to fuse: the port's factory
    raises ValueError for the same arguments as the JAX factory."""
    from supervised_dispnet_tpu.models import get_disp_net as jax_get_disp_net

    with pytest.raises(ValueError, match="fused-upsample"):
        jax_get_disp_net("dispnet", fused_upsample=True)
    with pytest.raises(ValueError, match="fused-upsample"):
        get_disp_net("dispnet", fused_upsample=True, device="cpu")


def test_downsample2x_avg_matches_jax():
    from supervised_dispnet_tpu.ops.resize import downsample2x_avg as jax_down

    x = np.random.default_rng(7).standard_normal((2, 32, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(downsample2x_avg(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_down(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="even"):
        downsample2x_avg(torch.zeros(1, 5, 8, 3))
