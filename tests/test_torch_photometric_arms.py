"""The photometric loss's other arms in the port (``losses/selfsup.py``:
``half_res``, ``batch_refs``, ``stochastic_stride``) and the training-output
images, against the JAX package on the CPU in fp32.

- Each arm of ``photometric_reconstruction_loss`` against JAX's on the same
  numpy inputs (the stochastic arm with its phases fixed): loss rtol 1e-4,
  gradients in depth, pose and mask rtol 1e-3 / atol 1e-3 of the largest,
  as ``tests/test_torch_selfsup_step.py`` holds the step (the warp's
  coordinates agree to fp32 rounding; the L1's and the masks' kinks are
  where the two may part).
- Within the port: ``batch_refs`` against the per-ref arm (the same sum
  over the same samples, regrouped: rtol 1e-5 / atol 1e-6); the mean of the
  stochastic loss over all s^2 phases against the full loss (the phase
  subsets partition the pixels: rtol 1e-5); the arm's refusals.
- One self-supervised step per arm against JAX's ``make_selfsup_train_step``
  (DispNetS + PoseExpNet, B=2, 32x64; the JAX step with SGD at lr 2^20, so
  its gradient is its update over -lr to float32 rounding even where the
  gradient is ~1e-9 of weights ~0.05; the stochastic arm given the phases
  JAX's step draws from its ``photo_key``): loss and terms rtol 1e-4,
  gradients rtol 1e-3 / atol 1e-3 of the tensor's largest.
- ``Trainer.log_images`` (``-f``) through a recording writer against the
  JAX trainer's ``_log_images`` on the same weights and snippet: the input
  exactly; the warped reference, and the disparity and the difference
  before their colour map, rtol 1e-4 / atol 1e-5; the colour-mapped images
  within 0.01, the largest step between neighbouring entries of the
  256-entry map (a value within rounding of an entry's edge may take
  either).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from supervised_dispnet_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from supervised_dispnet_tpu.losses import selfsup as js
from supervised_dispnet_tpu.models import DispNetS as JaxDispNetS
from supervised_dispnet_tpu.models import PoseExpNet as JaxPoseExpNet
from supervised_dispnet_tpu.parallel import make_mesh
from supervised_dispnet_tpu.training import create_train_state
from supervised_dispnet_tpu.training import make_selfsup_train_step as jax_make_step
from supervised_dispnet_tpu.training.trainer import Trainer as JaxTrainer
from supervised_dispnet_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from supervised_dispnet_tpu.utils import viz as jax_viz
from supervised_dispnet_tpu_torch.training import trainer as trainer_mod
from supervised_dispnet_tpu_torch.data.augment import AugmentConfig
from supervised_dispnet_tpu_torch.losses import selfsup as ts
from supervised_dispnet_tpu_torch.models import DispNetS, PoseExpNet
from supervised_dispnet_tpu_torch.ops.cuda import warp as kw
from supervised_dispnet_tpu_torch.training.train_step import make_selfsup_train_step
from supervised_dispnet_tpu_torch.training.trainer import Trainer, TrainerConfig
from supervised_dispnet_tpu_torch.utils.convert import dispnet_from_jax, posexpnet_from_jax
from supervised_dispnet_tpu_torch.utils.logging import NoopWriter
from tests.test_torch_selfsup import _close, _inputs
from tests.test_torch_selfsup_step import B, H, R, W, WEIGHTS, _batch, _port_models
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

ARMS = {"half_res": {"half_res": True}, "batch_refs": {"batch_refs": True},
        "stochastic": {"stochastic_stride": 2,
                       "stochastic_phases": ((0, 1), (1, 0), (1, 1), (0, 0))}}


def _torch_inputs(seed=0):
    tgt, refs, K, depths, masks, pose = _inputs(seed)
    return (torch.from_numpy(tgt), [torch.from_numpy(r) for r in refs], torch.from_numpy(K),
            [torch.from_numpy(d).requires_grad_(True) for d in depths],
            [torch.from_numpy(m).requires_grad_(True) for m in masks],
            torch.from_numpy(pose).requires_grad_(True))


def _port_loss(kw_, seed=0, with_masks=True):
    tgt, refs, K, depths, masks, pose = _torch_inputs(seed)
    loss, warped = ts.photometric_reconstruction_loss(
        tgt, refs, K, depths, masks if with_masks else None, pose, **kw_)
    loss.backward()
    return loss, warped, [d.grad for d in depths], [m.grad for m in masks], pose.grad


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_each_arm_matches_jax(arm):
    tgt, refs, K, depths, masks, pose = _inputs()

    def jax_loss(depths, pose, masks):
        return js.photometric_reconstruction_loss(
            jnp.asarray(tgt), [jnp.asarray(r) for r in refs], jnp.asarray(K), depths, masks,
            pose, **ARMS[arm])

    (j_loss, j_warped), j_grads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True))(
        [jnp.asarray(d) for d in depths], jnp.asarray(pose), [jnp.asarray(m) for m in masks])
    launches = (kw.warp_fwd_launches, kw.warp_bwd_coords_launches)
    t_loss, t_warped, t_dgrads, t_mgrads, t_pgrad = _port_loss(ARMS[arm])
    assert (kw.warp_fwd_launches, kw.warp_bwd_coords_launches) == launches

    _close(t_loss.item(), j_loss, rtol=1e-4)
    assert len(t_warped) == len(j_warped) == R
    for a, b in zip(t_warped, j_warped):
        assert a.shape == b.shape
        _close(a.detach(), b, rtol=1e-4, scale_atol=1e-4)
    for s in range(4):
        _close(t_dgrads[s], j_grads[0][s], rtol=1e-3, scale_atol=1e-3, msg=f"depth {s}")
        _close(t_mgrads[s], j_grads[2][s], rtol=1e-3, scale_atol=1e-3, msg=f"mask {s}")
    _close(t_pgrad, j_grads[1], rtol=1e-3, scale_atol=1e-3, msg="pose")


@pytest.mark.parametrize("with_masks", [True, False])
def test_batch_refs_equals_the_per_ref_arm(with_masks):
    """Loss, gradients and the logged finest warps, also under remat."""
    base = _port_loss({}, with_masks=with_masks)
    for kw_ in ({"batch_refs": True}, {"batch_refs": True, "remat": True}):
        got = _port_loss(kw_, with_masks=with_masks)
        _close(got[0].item(), base[0].item(), rtol=1e-5)
        if not kw_.get("remat"):
            for a, b in zip(got[1], base[1]):
                _close(a.detach(), b.detach(), rtol=1e-5, scale_atol=1e-6)
        grads = [*got[2], *(got[3] if with_masks else []), got[4]]
        ref = [*base[2], *(base[3] if with_masks else []), base[4]]
        for a, b in zip(grads, ref):
            _close(a, b, rtol=1e-5, scale_atol=1e-6)


@pytest.mark.parametrize("half_res", [False, True])
def test_stochastic_mean_over_all_phases_is_the_full_loss(half_res):
    """Each phase's term is the full term restricted to that phase's pixels
    (the phase-adjusted intrinsics make the subsampled warp exactly the full
    warp there), so the mean over the s^2 phases is the full loss."""
    full = _port_loss({"half_res": half_res})[0].item()
    s = 2
    losses = [_port_loss({"half_res": half_res, "stochastic_stride": s,
                          "stochastic_phases": ((oy, ox),) * 4})[0].item()
              for oy in range(s) for ox in range(s)]
    np.testing.assert_allclose(np.mean(losses), full, rtol=1e-5)
    assert np.std(losses) > 0  # a subsample, not a copy


def test_stochastic_arm_draws_its_phases_from_the_host_generator():
    """Phases drawn per scale from a CPU generator: the same seed gives the
    same loss, the explicit phases that ``draw_phases`` returns give it too,
    and the remat arm recomputes with the phases it drew."""
    kw_ = {"stochastic_stride": 2}
    a = _port_loss({**kw_, "generator": torch.Generator().manual_seed(3)})
    b = _port_loss({**kw_, "generator": torch.Generator().manual_seed(3)})
    phases = ts.draw_phases(2, 4, torch.Generator().manual_seed(3))
    c = _port_loss({**kw_, "stochastic_phases": phases})
    r = _port_loss({**kw_, "remat": True, "generator": torch.Generator().manual_seed(3)})
    assert a[0].item() == b[0].item() == c[0].item()
    _close(r[0].item(), a[0].item(), rtol=1e-6)
    _close(r[4], a[4], rtol=1e-5, scale_atol=1e-6)
    assert all(0 <= v < 2 for p in phases for v in p)


@pytest.mark.parametrize("kw_,err", [
    ({"stochastic_stride": 2, "batch_refs": True,
      "stochastic_phases": ((0, 0),) * 4}, "per-ref"),
    ({"stochastic_stride": 2}, "generator"),
    ({"stochastic_stride": 3, "stochastic_phases": ((0, 0),) * 4}, "divide"),
])
def test_stochastic_arm_refusals(kw_, err):
    """Beside ``batch_refs``, without a generator or phases, and with a
    stride that does not divide a scale (32x64: 3 divides none), as JAX
    refuses them."""
    with pytest.raises(ValueError, match=err):
        _port_loss(kw_)


SGD_LR = 2.0 ** 20
STEP_ARMS = {"half_res": {"half_res_photo": True}, "batch_refs": {"batch_refs": True},
             "stochastic": {"stochastic_photo": 2}}


@pytest.fixture(scope="module")
def jax_state():
    dmodel, pmodel = JaxDispNetS(), JaxPoseExpNet(nb_ref_imgs=R)
    zeros = jnp.zeros((B, H, W, 3))
    state = create_train_state(dmodel, (zeros,), optax.sgd(SGD_LR), seed=0,
                               extra_models={"pose": (pmodel, (zeros, [zeros] * R))})
    # a pose of ~1e-2, away from whole-pixel coordinates (as
    # test_torch_selfsup_step.py sets it)
    params = jax.device_get(state.params)
    params["pose"]["pose_pred"]["bias"] = np.random.default_rng(1).normal(
        0.0, 2.0, (6 * R,)).astype(np.float32)
    return dmodel, pmodel, state.replace(params=jax.tree.map(jnp.asarray, params))


@pytest.mark.parametrize("arm", sorted(STEP_ARMS))
def test_selfsup_step_of_each_arm_matches_jax(jax_state, arm):
    dmodel, pmodel, state = jax_state
    opts = STEP_ARMS[arm]
    batch = _batch()
    step = jax_make_step(dmodel, pmodel, nb_ref_imgs=R, donate=False,
                         aug=JaxAugmentConfig(flip=False, scale_crop=False, color_jitter=False),
                         **WEIGHTS, **opts)
    new_state, ref = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    phases = None
    if "stochastic_photo" in opts:
        # the JAX step's own draws: its photo_key, folded per scale
        photo_key = jax.random.split(state.rng, 3)[2]
        phases = tuple(tuple(int(v) for v in jax.random.randint(
            jax.random.fold_in(photo_key, s), (2,), 0, 2)) for s in range(4))

    params0 = jax.device_get(state.params)
    disp, pose = _port_models(params0)
    opt = torch.optim.SGD(list(disp.parameters()) + list(pose.parameters()), lr=1.0)
    port_step = make_selfsup_train_step(
        disp, pose, opt, nb_ref_imgs=R, aug=AugmentConfig(flip=False, scale_crop=False,
                                                          color_jitter=False),
        **WEIGHTS, **opts)
    out = port_step({k: torch.from_numpy(v) for k, v in batch.items()}, photo_phases=phases)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-4, err_msg=k)
    new = jax.device_get(new_state.params)
    for net, model, conv in (("disp", disp, dispnet_from_jax),
                             ("pose", pose, posexpnet_from_jax)):
        before, after = conv(params0[net]), conv(new[net])
        for name, p in model.named_parameters():
            g = (before[name] - after[name]).numpy() / SGD_LR
            np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-3,
                                       atol=1e-3 * float(np.abs(g).max()),
                                       err_msg=f"{arm} {net} {name}")


class RecordingWriter(NoopWriter):
    def __init__(self):
        self.images = {}

    def add_image(self, tag, img, step):
        self.images[tag] = (np.asarray(img, np.float32), step)


def test_training_output_images_match_jax(tmp_path, monkeypatch):
    """``-f``: train/disp, train/input, train/warped and train/diff of the
    first snippet, from a B=1 eval-mode forward of the live weights."""
    mapped = {"jax": [], "port": []}  # what each side hands its colour map
    for side, mod in (("jax", jax_viz), ("port", trainer_mod)):
        def recording(arr, *args, _real=mod.tensor2array, _side=side, **kwargs):
            mapped[_side].append(np.asarray(arr, np.float32))
            return _real(arr, *args, **kwargs)

        monkeypatch.setattr(mod, "tensor2array", recording)
    jcfg = JaxTrainerConfig(save_path=str(tmp_path / "j"), loss="selfsup", batch_size=B,
                            img_height=H, img_width=W)
    jtrainer = JaxTrainer(jcfg, JaxDispNetS(), JaxPoseExpNet(nb_ref_imgs=R),
                          mesh=make_mesh(jax.devices()[:1]))
    params = jax.device_get(jtrainer.state.params)
    params["pose"]["pose_pred"]["bias"] = np.random.default_rng(1).normal(
        0.0, 2.0, (6 * R,)).astype(np.float32)
    jtrainer.state = jtrainer.state.replace(params=jax.tree.map(jnp.asarray, params))
    batch = _batch(2)
    jtrainer.tb = RecordingWriter()
    jtrainer._log_images(batch, step=7)

    disp, pose = _port_models(params)
    trainer = Trainer(TrainerConfig(save_path=str(tmp_path / "t"), loss="selfsup",
                                    batch_size=B, training_output_freq=1),
                      disp, pose, device="cpu")
    trainer.tb = RecordingWriter()
    launches = kw.warp_fwd_launches
    trainer.log_images(batch, step=7)
    assert kw.warp_fwd_launches == launches

    got, ref = trainer.tb.images, jtrainer.tb.images
    assert set(got) == set(ref) == {"train/disp", "train/input", "train/warped",
                                    "train/diff"}
    for tag, tol in (("train/input", (0, 0)), ("train/warped", (1e-4, 1e-5)),
                     ("train/diff", (0, 0.01)), ("train/disp", (0, 0.01))):
        assert got[tag][1] == ref[tag][1] == 7
        assert got[tag][0].shape == ref[tag][0].shape == (3, H, W), tag
        np.testing.assert_allclose(got[tag][0], ref[tag][0], rtol=tol[0], atol=tol[1],
                                   err_msg=tag)
    # the disparity and the difference before the colour map
    assert len(mapped["port"]) == len(mapped["jax"]) == 2
    for a, b in zip(mapped["port"], mapped["jax"]):
        assert a.shape == b.shape == (H, W)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
