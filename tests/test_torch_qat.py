"""The port's quantization-aware training (``ops/quant.py::
fake_quant_methods``, ``fake_quant=True`` in the step builders) against the
JAX package's on the CPU.

- ``qdq_ste``: forward on the int8 grid, gradient the identity inside the
  range, as JAX's ``_qdq_ste``.
- One fake-quant supervised step (BerHu, DispResNet-18, 64x96) and one
  self-supervised step (DispNetS + PoseExpNet, 32x64; the pose net stays
  float) against JAX's ``fake_quant=True`` steps (their recipe: the disp
  net's forward under JAX's ``fake_quant_methods``). The losses: rtol 1e-4
  supervised, 1e-3 self-supervised (measured 1.5e-4: the QDQ rounds values
  the two frameworks compute to fp32 rounding, and one on a half rounds to
  either side). The gradients cannot be held at the rtol 1e-3 of the float
  step tests: under fake quant they are not fixed by the inputs at fp32
  rounding. Scaling one stem weight by 1 + 2^-22 moves the port's own
  encoder gradients by 42% rel-L2 (the heads' by 0.2%), and JAX's fake-quant
  gradients part from its float ones by 57% (the port's by the same). So
  every gradient is held by its direction and size against JAX's (cosine
  >= 0.7, norm ratio 0.5..2; measured rel-L2 <= 0.52, i.e. cosine >= 0.86),
  and the finest disparity head's, which the chaos barely reaches, by
  rel-L2 <= 1e-2 (supervised only: the self-supervised heads' gradients
  pass through the warp).
- The fake-quant fused decoder stage mirrors the port's int8 stage on the
  same scales (rtol 1e-4 / atol 1e-4, as JAX's test), and JAX's
  fake-quant stage (rtol 1e-4 / atol 1e-5).
- Fake quant with the bf16 trunk (DispResNet-18: ROADMAP C7 keeps CPU
  bf16 training of DispNetS and PoseExpNet at 128 px and above): the loss
  finite and within 5% of the fp32 fake-quant step's, each gradient's norm
  within 0.5..2 of it, as ``tests/test_torch_train_options.py`` holds the
  bf16 encoder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from supervised_dispnet_tpu.data.augment import augment_batch as jax_augment_batch
from supervised_dispnet_tpu.losses import selfsup as js
from supervised_dispnet_tpu.losses.supervised import multiscale_supervised_loss as jax_msl
from supervised_dispnet_tpu.models import DispNetS as JaxDispNetS
from supervised_dispnet_tpu.models import DispResNet as JaxDispResNet
from supervised_dispnet_tpu.models import PoseExpNet as JaxPoseExpNet
from supervised_dispnet_tpu.models.dispresnet import _FusedUpConvParams
from supervised_dispnet_tpu.ops import quant as jq
from supervised_dispnet_tpu.ops.pallas import berhu_loss_pallas
from supervised_dispnet_tpu.training import create_train_state
from supervised_dispnet_tpu_torch.models import DispResNet
from supervised_dispnet_tpu_torch.models.common import set_compute_dtype
from supervised_dispnet_tpu_torch.ops import quant as pq
from supervised_dispnet_tpu_torch.training.train_step import (
    make_selfsup_train_step, make_supervised_train_step)
from supervised_dispnet_tpu_torch.training.trainer import TrainerConfig, build_optimizer
from supervised_dispnet_tpu_torch.utils.convert import (
    dispnet_from_jax, dispresnet_from_jax, j2t_conv, posexpnet_from_jax)
from tests import test_torch_selfsup_step as ss
from tests import test_torch_train_step as sv
from tests.torch_threads import cap_torch_threads

cap_torch_threads()


def test_qdq_ste_gradient_is_identity_inside_range():
    x = torch.linspace(-1.0, 1.0, 31, requires_grad=True)
    scale = torch.tensor(1.0 / 127.0)
    y = pq.qdq_ste(x, scale)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.ones(31), atol=1e-6)
    yn = y.detach().numpy()
    np.testing.assert_allclose(yn, np.round(yn / float(scale)) * float(scale), atol=1e-7)
    want = np.asarray(jq._qdq_ste(jnp.linspace(-1.0, 1.0, 31), jnp.float32(1.0 / 127.0)))
    np.testing.assert_array_equal(yn, want)


@pytest.fixture(scope="module")
def supervised():
    """The JAX fake-quant step's gradients (its recipe: the disp net's
    forward under ``fake_quant_methods``) and the port's step."""
    B, H, W, depth = sv.B, sv.H, sv.W, sv.DEPTH
    model = JaxDispResNet(encoder_depth=depth)
    state = create_train_state(model, (jnp.zeros((B, H, W, 3)),), optax.adam(sv.LR), seed=0)
    batch = sv._batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        imgs, _, gt = jax_augment_batch(
            jax.random.PRNGKey(0), jb["tgt"].astype(jnp.float32)[:, None] / 255.0,
            jb["intrinsics"], jb["depth"].astype(jnp.float32), config=sv.JAX_NO_AUG)
        mask = (gt > 0) & (gt < 80.0)
        with jq.fake_quant_methods():
            disps, _ = model.apply({"params": params, "batch_stats": state.batch_stats["disp"]},
                                   imgs[:, 0], train=True, mutable=["batch_stats"])
        return jax_msl([1.0 / d[..., 0] for d in disps], gt, mask,
                       lambda p, g, m: berhu_loss_pallas(p, g, m, interpret=True))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(state.params["disp"])
    params0 = jax.device_get(state.params["disp"])
    stats0 = jax.device_get(state.batch_stats["disp"])
    port = DispResNet(depth)
    port.load_state_dict(dispresnet_from_jax(params0, stats0, depth), strict=True)
    opt = build_optimizer(TrainerConfig(lr=sv.LR), port.parameters())
    out = make_supervised_train_step(port, opt, "berhu", aug=sv.NO_AUG, fake_quant=True)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return {"ref_loss": float(ref_loss), "loss": float(out["loss"]), "port": port,
            "ref_grads": dispresnet_from_jax(jax.device_get(ref_grads), stats0, depth),
            "params0": params0, "stats0": stats0, "batch": batch}


def _hold_gradients(net: torch.nn.Module, want: dict, heads: bool) -> None:
    for name, p in net.named_parameters():
        g, w = p.grad.numpy().ravel(), want[name].numpy().ravel()
        nw = np.linalg.norm(w)
        if nw == 0:
            assert np.linalg.norm(g) == 0, name
            continue
        cos = float(g @ w) / (np.linalg.norm(g) * nw)
        ratio = float(np.linalg.norm(g) / nw)
        assert cos >= 0.7 and 0.5 <= ratio <= 2.0, (name, cos, ratio)
        if heads and name.startswith("predict_disp1."):
            assert np.linalg.norm(g - w) / nw <= 1e-2, name


def test_supervised_fake_quant_step_matches_jax(supervised):
    np.testing.assert_allclose(supervised["loss"], supervised["ref_loss"], rtol=1e-4)
    _hold_gradients(supervised["port"], supervised["ref_grads"], heads=True)


def test_fake_quant_step_differs_from_float(supervised):
    """The QDQ bites: the float step's loss is another number."""
    port = DispResNet(sv.DEPTH)
    port.load_state_dict(dispresnet_from_jax(supervised["params0"], supervised["stats0"],
                                             sv.DEPTH))
    opt = build_optimizer(TrainerConfig(lr=sv.LR), port.parameters())
    out = make_supervised_train_step(port, opt, "berhu", aug=sv.NO_AUG)(
        {k: torch.from_numpy(v) for k, v in supervised["batch"].items()})
    assert float(out["loss"]) != supervised["loss"]
    assert abs(float(out["loss"]) / supervised["loss"] - 1) < 0.05


@pytest.mark.parametrize("remat", ["full", "conv"])
def test_fake_quant_under_remat_matches_without(supervised, remat):
    """``--qat --remat``: the recomputation in the backward runs under the
    QAT context of its forward, so the step is the one without remat (the
    same float32 operations: loss and gradients rtol 1e-5)."""
    from supervised_dispnet_tpu_torch.models.common import set_remat

    port = DispResNet(sv.DEPTH)
    port.load_state_dict(dispresnet_from_jax(supervised["params0"], supervised["stats0"],
                                             sv.DEPTH))
    set_remat(port, remat)
    opt = build_optimizer(TrainerConfig(lr=sv.LR), port.parameters())
    out = make_supervised_train_step(port, opt, "berhu", aug=sv.NO_AUG, fake_quant=True)(
        {k: torch.from_numpy(v) for k, v in supervised["batch"].items()})
    np.testing.assert_allclose(float(out["loss"]), supervised["loss"], rtol=1e-5)
    ref = dict(supervised["port"].named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].grad.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_fake_quant_composes_with_bf16_trunk(supervised):
    port = DispResNet(sv.DEPTH)
    port.load_state_dict(dispresnet_from_jax(supervised["params0"], supervised["stats0"],
                                             sv.DEPTH))
    set_compute_dtype(port, torch.bfloat16)
    opt = build_optimizer(TrainerConfig(lr=sv.LR), port.parameters())
    out = make_supervised_train_step(port, opt, "berhu", aug=sv.NO_AUG, fake_quant=True)(
        {k: torch.from_numpy(v) for k, v in supervised["batch"].items()})
    loss = float(out["loss"])
    assert np.isfinite(loss) and abs(loss / supervised["loss"] - 1) < 0.05
    ref = dict(supervised["port"].named_parameters())
    for name, p in port.named_parameters():
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), name
        ratio = float(p.grad.norm() / ref[name].grad.norm().clamp_min(1e-30))
        assert 0.5 <= ratio <= 2.0, (name, ratio)


def test_selfsup_fake_quant_step_matches_jax():
    B, H, W, R = ss.B, ss.H, ss.W, ss.R
    dmodel, pmodel = JaxDispNetS(), JaxPoseExpNet(nb_ref_imgs=R)
    zeros = jnp.zeros((B, H, W, 3))
    state = create_train_state(dmodel, (zeros,), optax.adam(ss.LR), seed=0,
                               extra_models={"pose": (pmodel, (zeros, [zeros] * R))})
    params = jax.device_get(state.params)
    params["pose"]["pose_pred"]["bias"] = np.random.default_rng(1).normal(
        0.0, 2.0, (6 * R,)).astype(np.float32)  # as test_torch_selfsup_step.py
    batch = ss._batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        snippet = jnp.concatenate([jb["tgt"][:, None], jb["ref_imgs"]],
                                  axis=1).astype(jnp.float32) / 255.0
        imgs, K = jax_augment_batch(jax.random.PRNGKey(0), snippet, jb["intrinsics"],
                                    config=ss.JAX_NO_AUG)
        tgt, refs = imgs[:, 0], [imgs[:, 1 + r] for r in range(R)]
        with jq.fake_quant_methods():
            disps = dmodel.apply({"params": params["disp"]}, tgt)
        masks, pose = pmodel.apply({"params": params["pose"]}, tgt, refs)
        photo, _ = js.photometric_reconstruction_loss(
            tgt, refs, K, [1.0 / d[..., 0] for d in disps], masks, pose)
        return (ss.WEIGHTS["photo_weight"] * photo
                + ss.WEIGHTS["mask_weight"] * js.explainability_loss(masks)
                + ss.WEIGHTS["smooth_weight"] * js.smooth_loss(disps))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, params))
    ref_grads = jax.device_get(ref_grads)
    disp, pose = ss._port_models(params)
    opt = build_optimizer(TrainerConfig(lr=ss.LR),
                          list(disp.parameters()) + list(pose.parameters()))
    out = make_selfsup_train_step(disp, pose, opt, nb_ref_imgs=R, aug=ss.NO_AUG,
                                  fake_quant=True, **ss.WEIGHTS)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(out["loss"]), float(ref_loss), rtol=1e-3)
    _hold_gradients(disp, dispnet_from_jax(ref_grads["disp"]), heads=False)
    _hold_gradients(pose, posexpnet_from_jax(ref_grads["pose"]), heads=False)


def test_fake_quant_fused_stage_mirrors_int8_stage_and_jax():
    ch = cout = 8
    cs = 7
    rng = np.random.default_rng(11)
    h = rng.normal(0, 1, (2, 8, 12, ch)).astype(np.float32)
    skip = rng.normal(0, 2, (2, 16, 24, cs)).astype(np.float32)
    m = _FusedUpConvParams(features=cout, in_features=ch + cs)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(skip))
    v = jax.tree.map(lambda a: a + 0.01, v)  # a bias away from 0
    want = np.asarray(jq._fake_quant_fused_upconv(m.bind(v), jnp.asarray(h),
                                                  jnp.asarray(skip)))
    conv = torch.nn.Conv2d(ch + cs, cout, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(j2t_conv(v["params"]["kernel"]))
        conv.bias.copy_(torch.from_numpy(np.asarray(v["params"]["bias"])))
    th, ts = (torch.from_numpy(a).permute(0, 3, 1, 2) for a in (h, skip))
    fq = pq._FakeQuant(None).fused(conv, th, ts).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(fq, want, rtol=1e-4, atol=1e-5)
    stage = pq.QFusedUpConv(conv, float(np.abs(h).max()), float(np.abs(skip).max()))
    with torch.no_grad():
        q8 = stage(th, ts).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(fq, q8, rtol=1e-4, atol=1e-4)
