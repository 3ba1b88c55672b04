"""One self-supervised train step of the port (DispNetS + PoseExpNet,
photometric + explainability + smoothness) against the JAX package's
``make_selfsup_train_step`` (its default XLA sampler, as the JAX trainer
runs it) on the CPU in fp32: B=2 3-frame snippets at 32x64, augmentation
off, the same weights carried across by ``dispnet_from_jax`` /
``posexpnet_from_jax``, the same uint8 images. Loss and its three terms
rtol 1e-4; every gradient of both nets rtol 1e-3 / atol 1e-3 of the
tensor's largest (convolutions sum in other orders in XLA and PyTorch, and
the warp's coordinates agree to fp32 rounding); then one eval step without
GT."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from supervised_dispnet_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from supervised_dispnet_tpu.data.augment import augment_batch as jax_augment_batch
from supervised_dispnet_tpu.losses import selfsup as js
from supervised_dispnet_tpu.models import DispNetS as JaxDispNetS
from supervised_dispnet_tpu.models import PoseExpNet as JaxPoseExpNet
from supervised_dispnet_tpu.training import (
    create_train_state, make_selfsup_eval_step as jax_make_eval,
    make_selfsup_train_step as jax_make_step)
from supervised_dispnet_tpu_torch.data.augment import AugmentConfig
from supervised_dispnet_tpu_torch.models import DispNetS, PoseExpNet
from supervised_dispnet_tpu_torch.ops.cuda import warp as kw
from supervised_dispnet_tpu_torch.training.train_step import (
    make_selfsup_eval_step, make_selfsup_train_step)
from supervised_dispnet_tpu_torch.training.trainer import TrainerConfig, build_optimizer
from supervised_dispnet_tpu_torch.utils.convert import dispnet_from_jax, posexpnet_from_jax

B, H, W, R = 2, 32, 64, 2
LR = 1e-3
WEIGHTS = {"photo_weight": 1.0, "mask_weight": 0.2, "smooth_weight": 0.1}
JAX_NO_AUG = JaxAugmentConfig(flip=False, scale_crop=False, color_jitter=False)
NO_AUG = AugmentConfig(flip=False, scale_crop=False, color_jitter=False)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    K = np.array([[30.0, 0, W / 2 - 0.5], [0, 31.0, H / 2 + 0.5], [0, 0, 1]], np.float32)
    return {"tgt": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
            "ref_imgs": rng.integers(0, 256, (B, R, H, W, 3), dtype=np.uint8),
            "intrinsics": np.tile(K, (B, 1, 1))}


def _port_models(params):
    disp, pose = DispNetS(), PoseExpNet(nb_ref_imgs=R)
    disp.load_state_dict(dispnet_from_jax(params["disp"]), strict=True)
    pose.load_state_dict(posexpnet_from_jax(params["pose"]), strict=True)
    return disp, pose


@pytest.fixture(scope="module")
def one_step():
    dmodel, pmodel = JaxDispNetS(), JaxPoseExpNet(nb_ref_imgs=R)
    zeros = jnp.zeros((B, H, W, 3))
    state = create_train_state(dmodel, (zeros,), optax.adam(LR), seed=0,
                               extra_models={"pose": (pmodel, (zeros, [zeros] * R))})
    # A pose of ~1e-2 (a bias on the pose head): at flax's zero-bias init
    # the pose is ~1e-4 and the warp's coordinates sit within ~1e-2 px of
    # whole pixels, some within fp32 rounding of them, where the two
    # frameworks' coordinates fall on either side and the coordinate
    # gradient switches between the left and the right difference.
    pose_bias = np.random.default_rng(1).normal(0.0, 2.0, (6 * R,)).astype(np.float32)
    params = jax.device_get(state.params)
    params["pose"]["pose_pred"]["bias"] = pose_bias
    state = state.replace(params=jax.tree.map(jnp.asarray, params))
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    # the gradients the JAX step applies, by the step's own recipe
    def loss_fn(params):
        snippet = jnp.concatenate([jbatch["tgt"][:, None], jbatch["ref_imgs"]],
                                  axis=1).astype(jnp.float32) / 255.0
        imgs, K = jax_augment_batch(jax.random.PRNGKey(0), snippet, jbatch["intrinsics"],
                                    config=JAX_NO_AUG)
        tgt, refs = imgs[:, 0], [imgs[:, 1 + r] for r in range(R)]
        disps = dmodel.apply({"params": params["disp"]}, tgt)
        masks, pose = pmodel.apply({"params": params["pose"]}, tgt, refs)
        photo, _ = js.photometric_reconstruction_loss(
            tgt, refs, K, [1.0 / d[..., 0] for d in disps], masks, pose)
        return (WEIGHTS["photo_weight"] * photo
                + WEIGHTS["mask_weight"] * js.explainability_loss(masks)
                + WEIGHTS["smooth_weight"] * js.smooth_loss(disps))

    ref_loss_fn, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    step = jax_make_step(dmodel, pmodel, nb_ref_imgs=R, aug=JAX_NO_AUG, donate=False,
                         use_pallas_warp=False, **WEIGHTS)
    new_state, metrics = step(state, jbatch)
    params0 = jax.device_get(state.params)

    disp, pose = _port_models(params0)
    opt = build_optimizer(TrainerConfig(lr=LR),
                          list(disp.parameters()) + list(pose.parameters()))
    port_step = make_selfsup_train_step(disp, pose, opt, nb_ref_imgs=R, aug=NO_AUG,
                                        **WEIGHTS)
    launches = (kw.warp_fwd_launches, kw.warp_bwd_coords_launches)
    out = port_step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert (kw.warp_fwd_launches, kw.warp_bwd_coords_launches) == launches
    ref_grads = jax.device_get(ref_grads)
    return {"ref": {k: float(v) for k, v in metrics.items()},
            "ref_loss_fn": float(ref_loss_fn), "out": {k: float(v) for k, v in out.items()},
            "ref_grads": {"disp": dispnet_from_jax(ref_grads["disp"]),
                          "pose": posexpnet_from_jax(ref_grads["pose"])},
            "ref_new": jax.device_get(new_state.params), "nets": {"disp": disp, "pose": pose},
            "new_state": new_state, "models": (dmodel, pmodel)}


def test_step_loss_and_terms_match_jax(one_step):
    assert one_step["ref"]["loss"] == pytest.approx(one_step["ref_loss_fn"], rel=1e-6)
    assert set(one_step["out"]) == set(one_step["ref"])
    for k, v in one_step["ref"].items():
        np.testing.assert_allclose(one_step["out"][k], v, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("net", ["disp", "pose"])
def test_step_gradients_match_jax(one_step, net):
    model = one_step["nets"][net]
    ref = one_step["ref_grads"][net]
    assert {n for n, _ in model.named_parameters()} == set(ref)
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(r).max()), err_msg=name)


def test_step_adam_update_matches_optax(one_step):
    """Both nets after the first Adam update, atol 1e-6, on entries whose
    gradient is above 1e-3 of the tensor's largest (the first update is
    about lr * sign(g): near g = 0 the sign rests on rounding)."""
    for net, conv in (("disp", dispnet_from_jax), ("pose", posexpnet_from_jax)):
        new = conv(one_step["ref_new"][net])
        grads = one_step["ref_grads"][net]
        for name, p in one_step["nets"][net].named_parameters():
            g = grads[name].numpy()
            sel = np.abs(g) > 1e-3 * np.abs(g).max()
            np.testing.assert_allclose(p.detach().numpy()[sel], new[name].numpy()[sel],
                                       rtol=0, atol=1e-6, err_msg=f"{net} {name}")


def test_eval_step_without_gt_matches_jax(one_step):
    """Validation without GT after the update: photometric, explainability
    and smoothness on raw uint8 snippets with the unaugmented intrinsics."""
    batch = _batch(1)
    st = one_step["new_state"]
    dmodel, pmodel = one_step["models"]
    ref = jax_make_eval(dmodel, pmodel, nb_ref_imgs=R, aug=JAX_NO_AUG)(
        st.params, st.batch_stats, {k: jnp.asarray(v) for k, v in batch.items()})
    disp, pose = _port_models(jax.device_get(st.params))
    got = make_selfsup_eval_step(disp, pose, nb_ref_imgs=R, aug=NO_AUG)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4, err_msg=k)
