"""One supervised BerHu train step of the port against the JAX package's
``make_supervised_train_step(use_pallas_losses=True)`` on the CPU in fp32:
DispResNet-18 at 64x96, B=2, augmentation off, the same weights carried
across with ``dispresnet_from_jax``, the same uint8 images and fp16 depth.
The JAX BerHu runs the Pallas kernel in interpret mode, the port's the
plain version (a CPU tensor)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from supervised_dispnet_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from supervised_dispnet_tpu.data.augment import augment_batch as jax_augment_batch
from supervised_dispnet_tpu.losses.supervised import multiscale_supervised_loss as jax_msl
from supervised_dispnet_tpu.models import DispResNet as JaxDispResNet
from supervised_dispnet_tpu.ops.pallas import berhu_loss_pallas
from supervised_dispnet_tpu.training import (
    create_train_state, make_eval_step as jax_make_eval_step,
    make_supervised_train_step as jax_make_step)
from supervised_dispnet_tpu_torch.data.augment import AugmentConfig
from supervised_dispnet_tpu_torch.models import DispResNet
from supervised_dispnet_tpu_torch.ops.cuda import losses as kl
from supervised_dispnet_tpu_torch.parallel import make_mesh
from supervised_dispnet_tpu_torch.training.train_step import (
    make_eval_step, make_supervised_train_step)
from supervised_dispnet_tpu_torch.training.trainer import TrainerConfig, build_optimizer
from supervised_dispnet_tpu_torch.utils.convert import dispresnet_from_jax
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

DEPTH, B, H, W = 18, 2, 64, 96
LR = 1e-3
JAX_NO_AUG = JaxAugmentConfig(flip=False, scale_crop=False, color_jitter=False)
NO_AUG = AugmentConfig(flip=False, scale_crop=False, color_jitter=False)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    depth = rng.uniform(1.0, 60.0, (B, H, W)) * (rng.uniform(size=(B, H, W)) < 0.3)
    return {"tgt": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
            "intrinsics": np.tile(K, (B, 1, 1)),
            "depth": depth.astype(np.float16)}


@pytest.fixture(scope="module")
def one_step():
    """Both steps from the same weights on the same batch."""
    model = JaxDispResNet(encoder_depth=DEPTH)
    state = create_train_state(model, (jnp.zeros((B, H, W, 3)),), optax.adam(LR), seed=0)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    # the gradients the JAX step applies, by the step's own recipe, compiled
    # once (op by op it took several times as long)
    def loss_fn(params):
        imgs, _, depth = jax_augment_batch(
            jax.random.PRNGKey(0), jbatch["tgt"].astype(jnp.float32)[:, None] / 255.0,
            jbatch["intrinsics"], jbatch["depth"].astype(jnp.float32), config=JAX_NO_AUG)
        mask = (depth > 0) & (depth < 80.0)
        disps, _ = model.apply({"params": params, "batch_stats": state.batch_stats["disp"]},
                               imgs[:, 0], train=True, mutable=["batch_stats"])
        return jax_msl([1.0 / d[..., 0] for d in disps], depth, mask,
                       lambda p, g, m: berhu_loss_pallas(p, g, m, interpret=True))

    ref_loss_fn, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(state.params["disp"])
    step = jax_make_step(model, "berhu", aug=JAX_NO_AUG, donate=False,
                         use_pallas_losses=True)
    new_state, metrics = step(state, jbatch)
    params0 = jax.device_get(state.params["disp"])
    stats0 = jax.device_get(state.batch_stats["disp"])

    port = DispResNet(DEPTH)
    port.load_state_dict(dispresnet_from_jax(params0, stats0, DEPTH), strict=True)
    opt = build_optimizer(TrainerConfig(lr=LR), port.parameters())
    port_step = make_supervised_train_step(port, opt, "berhu", aug=NO_AUG)
    launches = (kl.berhu_fwd_launches, kl.berhu_bwd_launches)
    out = port_step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert (kl.berhu_fwd_launches, kl.berhu_bwd_launches) == launches

    ref_grad_sd = dispresnet_from_jax(jax.device_get(ref_grads), stats0, DEPTH)
    ref_new_sd = dispresnet_from_jax(jax.device_get(new_state.params["disp"]),
                                     jax.device_get(new_state.batch_stats["disp"]), DEPTH)
    return {"ref_loss": float(metrics["loss"]), "ref_loss_fn": float(ref_loss_fn),
            "ref_grads": ref_grad_sd, "ref_new": ref_new_sd, "loss": float(out["loss"]),
            "port": port, "batch": batch, "new_state": new_state, "model": model}


def test_step_loss_matches_jax(one_step):
    assert one_step["ref_loss"] == pytest.approx(one_step["ref_loss_fn"], rel=1e-6)
    np.testing.assert_allclose(one_step["loss"], one_step["ref_loss"], rtol=1e-4)


def test_step_gradients_match_jax(one_step):
    """Every parameter's gradient, rtol 1e-3 / atol 1e-5 (convolutions sum
    in another order in XLA and in PyTorch)."""
    names = [n for n, _ in one_step["port"].named_parameters()]
    assert len(names) == len([k for k in one_step["ref_grads"] if "running_" not in k])
    for name, p in one_step["port"].named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), one_step["ref_grads"][name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_step_batchnorm_stats_match_jax(one_step):
    """Running mean and (biased-variance) running var after the step."""
    sd = one_step["port"].state_dict()
    keys = [k for k in one_step["ref_new"] if "running_" in k]
    assert keys
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), one_step["ref_new"][k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_step_adam_update_matches_optax(one_step):
    """Parameters after the first Adam update, atol 1e-6, on entries whose
    gradient is above 1e-5. The first update is lr * g / (|g| + eps), about
    lr * sign(g): where g is near 0 its sign rests on rounding, and the two
    may differ there by up to 2 * lr."""
    for name, p in one_step["port"].named_parameters():
        g = one_step["ref_grads"][name].numpy()
        sel = np.abs(g) > 1e-5
        np.testing.assert_allclose(p.detach().numpy()[sel],
                                   one_step["ref_new"][name].numpy()[sel],
                                   rtol=0, atol=1e-6, err_msg=name)


def test_eval_step_matches_jax(one_step):
    """The validation step after the update: the Eigen metrics, with the
    updated running stats, uint8 images and fp16 depth."""
    rng = np.random.default_rng(1)
    depth = rng.uniform(1.0, 60.0, (B, H, W)) * (rng.uniform(size=(B, H, W)) < 0.3)
    batch = {"img": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
             "depth": depth.astype(np.float16)}
    st = one_step["new_state"]
    ref = jax_make_eval_step(one_step["model"], aug=JAX_NO_AUG)(
        st.params, st.batch_stats, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_step(one_step["port"], aug=NO_AUG)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("kw", [{"mesh": "one rank"},
                                {"mesh": "one rank", "fake_quant": True, "ema_decay": 0.99},
                                {"mesh": "one rank", "fake_quant": True}])
def test_unported_step_options_raise(kw):
    """The JAX step's mesh, once the option still to port, is ported
    (``parallel/mesh.py``): a mesh of one rank (``make_mesh()`` with no
    process group) gives the plain step bit for bit, the loss and every
    parameter and buffer after it, alone and beside ported options (EMA,
    QAT)."""
    kw = {**kw, "mesh": make_mesh()}
    assert kw["mesh"].size == 1
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    out = {}
    for with_mesh in (True, False):
        model = DispResNet(18, generator=torch.Generator().manual_seed(4))
        opt = torch.optim.Adam(model.parameters(), lr=LR)
        opts = kw if with_mesh else {k: v for k, v in kw.items() if k != "mesh"}
        step = make_supervised_train_step(model, opt, "berhu", aug=NO_AUG, **opts)
        loss = step(batch)["loss"]
        out[with_mesh] = (loss, model.state_dict(), step.update.ema)
    assert torch.equal(out[True][0], out[False][0])
    for k, v in out[False][1].items():
        assert torch.equal(out[True][1][k], v), k
    if kw.get("ema_decay"):
        assert all(torch.equal(a, b) for a, b in zip(out[True][2], out[False][2]))
