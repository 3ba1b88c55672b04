"""The port's VGG16-BN and FCRN networks (``models/disp_vgg_bn.py``,
``models/fcrn.py``) against the JAX package's, on the CPU.

Forwards in eval and train mode (BatchNorm on batch statistics, and the
running statistics it updates), on weights carried by
``disp_vgg_bn_from_jax`` / ``fcrn_from_jax`` with BN scales, biases and
statistics away from their init: rtol 1e-3 / atol 2e-4, as
``tests/test_checkpoint_convert.py`` sets them for disparity nets (XLA and
PyTorch sum the convolutions in other orders). VGG-BN fused against
unfused, the same function: rtol 1e-5 / atol 1e-5. The converters against
JAX's ``convert_network``, which reads a ``.pth.tar`` that the port writes:
exact. FCRN's up-projection against the reference's unpool-then-conv
(``tests/torch_ref.py::TorchUpProj``): rtol 1e-5 / atol 1e-5, one
float32 computation reordered. The single-map loss branch against JAX's
supervised step on a one-conv depth network: loss rtol 1e-4, gradients rtol
1e-3, as ``tests/test_torch_train_step.py`` holds the step. No JAX gradient
of a VGG16 or a ResNet-50 runs here."""

import copy
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from supervised_dispnet_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from supervised_dispnet_tpu.models import FCRN as JaxFCRN
from supervised_dispnet_tpu.models import DispVggBN as JaxDispVggBN
from supervised_dispnet_tpu.training import create_train_state
from supervised_dispnet_tpu.training import make_supervised_train_step as jax_make_step
from supervised_dispnet_tpu.utils.checkpoint import load_torch_state_dict as jax_load_sd
from supervised_dispnet_tpu.utils.convert_models import convert_network
from supervised_dispnet_tpu_torch.cli import train as train_cli
from supervised_dispnet_tpu_torch.data.augment import AugmentConfig
from supervised_dispnet_tpu_torch.models import FCRN, DispVggBN, get_disp_net
from supervised_dispnet_tpu_torch.models.fcrn import UpProjection
from supervised_dispnet_tpu_torch.ops.cuda import losses as kl
from supervised_dispnet_tpu_torch.training.train_step import make_supervised_train_step
from supervised_dispnet_tpu_torch.utils.convert import (
    disp_vgg_bn_from_jax, fcrn_from_jax, j2t_conv)
from tests.torch_ref import TorchUpProj
from tests.test_torch_port import _packed_split
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

B, H, W = 2, 64, 96


def _randomize(tree, rng):
    """BN scale, bias and running statistics, and conv biases, away from
    their init."""
    def leaf(path, x):
        name = str(path[-1])
        if "var" in name or "scale" in name:
            return rng.uniform(0.5, 1.5, np.shape(x)).astype(np.float32)
        if "mean" in name or "bias" in name:
            return (0.1 * rng.standard_normal(np.shape(x))).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _jax_run(model, seed):
    """The JAX model's randomised weights, an input, and its outputs in eval
    and train mode, with the running statistics the train forward leaves.

    The running statistics are then set to the batch's own mean and its
    variance plus 1 (what training makes of them, kept away from 0): with
    random ones a 50-layer ResNet's eval activations grow to ~1e4, and
    FCRN's unbounded head passes that on to its output; a channel of ~0
    variance would scale its rounding by 1 / sqrt(eps)."""
    x = np.random.default_rng(seed + 1).uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros_like(x))
    rng = np.random.default_rng(seed)
    params = _randomize(jax.device_get(v["params"]), rng)
    stats = _randomize(jax.device_get(v["batch_stats"]), rng)
    train = jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"]))
    evaluate = jax.jit(lambda v, x: model.apply(v, x, train=False))
    _, upd = train({"params": params, "batch_stats": stats}, x)
    # flax: running = 0.9 * running + 0.1 * batch statistic
    stats = jax.tree_util.tree_map_with_path(
        lambda path, new, old: (new - 0.9 * old) / 0.1 + ("var" in str(path[-1])),
        jax.device_get(upd["batch_stats"]), stats)
    v = {"params": params, "batch_stats": stats}
    tr, upd = train(v, x)
    return (params, stats, x, jax.device_get(evaluate(v, x)), jax.device_get(tr),
            jax.device_get(upd))


@pytest.fixture(scope="module")
def vgg():
    return _jax_run(JaxDispVggBN(), 1)


@pytest.fixture(scope="module")
def fcrn():
    return _jax_run(JaxFCRN(), 3)


@pytest.fixture(scope="module")
def ported(vgg, fcrn):
    """Each network of the port with the JAX weights, built once (a test
    takes a copy)."""
    nets = {"disp_vgg_bn": (DispVggBN(), disp_vgg_bn_from_jax, vgg),
            "fcrn": (FCRN(), fcrn_from_jax, fcrn)}
    for model, to_torch, run in nets.values():
        model.load_state_dict(to_torch(*run[:2]), strict=True)
    return {k: v[0] for k, v in nets.items()}


def _close(got, want):
    assert tuple(got.shape) == np.shape(want)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-3, atol=2e-4)


def _stats_close(model, want_sd):
    """Running statistics after a train forward, against the JAX update."""
    sd = model.state_dict()
    keys = [k for k in want_sd if "running_" in k]
    assert keys
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want_sd[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_disp_vgg_bn_matches_jax_in_eval_and_train_mode(vgg, ported, fused):
    params, stats, x, want_eval, want_train, updated = vgg
    model = copy.deepcopy(ported["disp_vgg_bn"])
    model.fused_upsample = fused
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
        assert len(got) == 4
        for g, w in zip(got, want_eval):
            _close(g, w)
        got = model.train()(torch.from_numpy(x))
    for g, w in zip(got, want_train):
        _close(g, w)
    _stats_close(model, disp_vgg_bn_from_jax(params, updated["batch_stats"]))


def test_disp_vgg_bn_fused_matches_unfused_and_needs_2x_geometry():
    fused = get_disp_net("disp_vgg_bn", fused_upsample=True, seed=5, device="cpu").eval()
    unfused = get_disp_net("disp_vgg_bn", seed=5, device="cpu").eval()
    x = torch.tensor(np.random.default_rng(6).uniform(-1, 1, (1, H, W, 3)), dtype=torch.float32)
    with torch.no_grad():
        for a, b in zip(fused(x), unfused(x)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
        with pytest.raises(ValueError, match="divisible by 32"):
            fused(torch.zeros(1, 48, W, 3))


def _rel_l2(got, want) -> float:
    want = np.asarray(want)
    return float(np.linalg.norm(np.asarray(got) - want) / np.linalg.norm(want))


def test_fcrn_matches_jax_in_eval_and_train_mode(fcrn, ported):
    """Eval mode elementwise. Train mode by relative L2: batch statistics
    over a ResNet-50's ReLU maps amplify the float32 rounding of the two
    frameworks (flax takes the batch variance as E[x^2] - E[x]^2, the port
    in two passes) to ~1e-3 of the output at 64x96 (9.2e-4 measured), the
    effect ``ROADMAP.md`` C4 records for DispResNet-50's gradients: output
    within rel-L2 2e-3, each running statistic within 2e-4 (3.3e-5
    measured)."""
    params, stats, x, want_eval, want_train, updated = fcrn
    model = copy.deepcopy(ported["fcrn"])
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
        _close(got, want_eval)  # one (B, H, W, 1) map, not a list
        got = model.train()(torch.from_numpy(x))
    assert tuple(got.shape) == want_train.shape
    assert _rel_l2(got.numpy(), want_train) <= 2e-3
    sd, want = model.state_dict(), fcrn_from_jax(params, updated["batch_stats"])
    keys = [k for k in want if "running_" in k]
    assert keys and max(_rel_l2(sd[k].numpy(), want[k].numpy()) for k in keys) <= 2e-4


@pytest.mark.parametrize("network", ["disp_vgg_bn", "fcrn"])
def test_converters_round_trip_through_jax_convert_network(vgg, fcrn, ported, network,
                                                          tmp_path):
    """A ``.pth.tar`` that the port writes, read by JAX's own reader and
    ``convert_network``, gives back the flax trees it was made from."""
    params, stats = (vgg if network == "disp_vgg_bn" else fcrn)[:2]
    torch.save({"epoch": 1, "state_dict": ported[network].state_dict()},
               tmp_path / "m.pth.tar")
    got_p, got_s = convert_network(jax_load_sd(tmp_path / "m.pth.tar"), network)
    (tmp_path / "m.pth.tar").unlink()
    for want, got in ((params, got_p), (stats, got_s)):
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]), np.asarray(leaf),
                                          err_msg=str(path))


def test_up_projection_matches_the_reference_unpool_then_conv():
    """The transposed conv against zero-stuffing then 5x5 convs, on a
    non-square input with Cin != Cout, in eval and train mode."""
    torch.manual_seed(0)
    ref = TorchUpProj(6, 4)
    for m in ref.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.1, 0.1)
            m.running_var.uniform_(0.5, 1.5)
            m.weight.data.uniform_(0.5, 1.5)
            m.bias.data.uniform_(-0.1, 0.1)
    port = UpProjection(6, 4)
    port.load_state_dict(ref.state_dict(), strict=True)
    x = torch.randn(2, 6, 5, 7)
    with torch.no_grad():
        for mode in (False, True):
            got, want = port.train(mode)(x), ref.train(mode)(x)
            assert got.shape == (2, 4, 10, 14)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


class _JaxOneConvDepth(nn.Module):
    """A network with FCRN's interface: one (B, H, W, 1) map of depth."""

    @nn.compact
    def __call__(self, x):
        return nn.relu(nn.Conv(1, (3, 3), padding=1)(x)) + 1.0


def test_single_map_loss_branch_matches_jax_supervised_step():
    """BerHu of a depth network's one map (FCRN's branch) in the port's step
    against JAX's step (Pallas BerHu in interpret mode), one conv wide."""
    rng = np.random.default_rng(7)
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    depth = rng.uniform(1.0, 60.0, (B, H, W)) * (rng.uniform(size=(B, H, W)) < 0.3)
    batch = {"tgt": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
             "intrinsics": np.tile(K, (B, 1, 1)), "depth": depth.astype(np.float16)}
    jmodel = _JaxOneConvDepth()
    state = create_train_state(jmodel, (jnp.zeros((B, H, W, 3)),), optax.sgd(1.0), seed=0)
    p0 = jax.device_get(state.params["disp"])
    jstep = jax_make_step(jmodel, "berhu", donate=False, use_pallas_losses=True,
                          aug=JaxAugmentConfig(flip=False, scale_crop=False,
                                               color_jitter=False))
    new_state, metrics = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})

    conv = torch.nn.Conv2d(3, 1, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(j2t_conv(p0["Conv_0"]["kernel"]))
        conv.bias.copy_(torch.tensor(np.asarray(p0["Conv_0"]["bias"])))

    class OneConvDepth(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = conv

        def forward(self, x):
            return (F.relu(self.conv(x.permute(0, 3, 1, 2))) + 1.0).permute(0, 2, 3, 1)

    model = OneConvDepth()
    step = make_supervised_train_step(model, torch.optim.SGD(model.parameters(), lr=1.0),
                                      "berhu", aug=AugmentConfig(flip=False, scale_crop=False,
                                                                 color_jitter=False))
    launches = (kl.berhu_fwd_launches, kl.berhu_bwd_launches)
    out = step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert (kl.berhu_fwd_launches, kl.berhu_bwd_launches) == launches
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), rtol=1e-4)
    # SGD with lr 1: the update is minus the gradient
    grad = p0["Conv_0"]["kernel"] - jax.device_get(new_state.params["disp"])["Conv_0"]["kernel"]
    np.testing.assert_allclose(conv.weight.grad.numpy(), j2t_conv(grad).numpy(), rtol=1e-3,
                               atol=1e-3 * float(np.abs(grad).max()))


@pytest.mark.parametrize("network", ["disp_vgg_bn", "fcrn"])
def test_cli_trains_each_network_two_steps_on_the_cpu(tmp_path, network):
    """Supervised BerHu through the train CLI at 32x64: two finite steps and
    a checkpoint that loads back strictly; no kernel launch on the CPU."""
    _packed_split(tmp_path / "data", 32, 64)
    launches = (kl.berhu_fwd_launches, kl.berhu_bwd_launches)
    trainer = train_cli.main([
        str(tmp_path / "data"), "--network", network, "--loss", "berhu", "-b", "2",
        "--epoch-size", "2", "--epochs", "1", "--device", "cpu",
        "--checkpoints-dir", str(tmp_path / "ck"), "--name", "t"])
    assert trainer.step == 2
    assert (kl.berhu_fwd_launches, kl.berhu_bwd_launches) == launches
    ckpt = torch.load(next((tmp_path / "ck").rglob("dispnet_checkpoint.pth.tar")),
                      weights_only=False)
    trainer.model.load_state_dict(ckpt["state_dict"], strict=True)
    shutil.rmtree(tmp_path / "ck")  # FCRN's two checkpoints take 1.5 GB
    disp = trainer.predict(np.random.default_rng(8).uniform(size=(1, 32, 64, 3)))
    assert disp.shape == (1, 32, 64) and np.isfinite(disp).all() and (disp > 0).all()
    # what the JAX factory refuses for the network, the port's refuses
    kw, err = ({"fused_upsample": True}, "fused-upsample") if network == "fcrn" else (
        {"head": "classification"}, "classification head")
    with pytest.raises(ValueError, match=err):
        get_disp_net(network, **kw, device="cpu")
