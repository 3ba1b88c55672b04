"""Data-parallel training of the port on the CPU, the slice's other
configurations: two gloo ranks (``tests/torch_ranks.py``) against the JAX
package's steps on a mesh of 2 of its virtual CPU devices, from the same
weights on the same global batches of 4 at 64x96, the default augmentation
(the port's ranks handed JAX's draws for the global batch):

- DispResNet-18 multi-scale classification (16 bins), 2 Adam steps: the
  CE's sum and count over the global batch; and the same on the two ranks
  as one spatial group (``--spatial-shards 2``: half the image rows each)
  and on 4 ranks as 2 data x 2 spatial, against the same JAX step, which
  computes what JAX's ``(data, spatial)`` mesh does
  (``tests/test_spatial.py``);
- DispResNet-18 BerHu with QAT, an EMA shadow and 2 micro-batches an
  update, 2 micro-steps: QAT's activation scales over the global batch, the
  accumulation of the averaged gradients into one update and the shadow's
  tick;
- DispNetS + PoseExpNet self-supervised, 2 Adam steps, with the
  explainability head unused (``mask_weight`` 0: its parameters get no
  gradient, which counts as zeros on every rank), and with it and
  ``stochastic_photo`` 2 (the port's ranks handed the phases JAX's step
  draws from its photo key);
- the self-supervised validation step (the supervised one is in
  ``tests/test_torch_parallel.py``).

Tolerances. The loss (and its terms) rtol 1e-4 at each step; BatchNorm's
running statistics rel-L2 1e-3 a tensor; the validation losses rtol 1e-4.
The parameters after the Adam steps, by ``update_gap`` (how far the port's
lie from JAX's, over how far JAX's steps moved them), as in
``tests/test_torch_parallel.py``: each decoder and head tensor within 1e-2
(classification; measured 7e-4), 5e-2 self-supervised (measured 2.2e-2 on
the pose head with the explainability head unused: the warp's coordinates
agree to fp32 rounding, and Adam's first updates, about lr * sign(g), take
the sign of a gradient entry where rounding decides it), the encoders as a
whole within 0.1 (measured 5.6e-3 and 1.2e-2; ROADMAP C4). Under QAT the
gradients are not fixed by the inputs at fp32 rounding
(``tests/test_torch_qat.py``: a 2^-22 nudge of one weight moves the
encoder's by 42%; and a value the QDQ rounds from a half lands on either
side), so what precedes the update is held near rounding (the losses of
both micro-steps rtol 1e-4, the running statistics rel-L2 5e-2, measured
1.8e-2 in layer4), and the update of the parameters and of the EMA shadow by its direction and
size: the encoder's as a whole at cosine >= 0.7 with JAX's, the decoder and
heads' at >= 0.95, each norm within 0.9..1.1 of JAX's (measured over two
updates: 0.82, 0.99 and 0.999..1.0002; after them the running statistics
part by up to 3.3e-2, as the micro-steps run on those parameters). The two
ranks hold the same state bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from supervised_dispnet_tpu.losses import classification as jax_cls
from supervised_dispnet_tpu.models import DispNetS as JaxDispNetS
from supervised_dispnet_tpu.models import DispResNet as JaxDispResNet
from supervised_dispnet_tpu.models import PoseExpNet as JaxPoseExpNet
from supervised_dispnet_tpu.parallel import make_mesh as jax_make_mesh
from supervised_dispnet_tpu.parallel import shard_batch as jax_shard_batch
from supervised_dispnet_tpu.training import (
    create_train_state, make_selfsup_eval_step as jax_make_selfsup_eval,
    make_selfsup_train_step as jax_make_selfsup_step,
    make_supervised_train_step as jax_make_step)
from supervised_dispnet_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from supervised_dispnet_tpu.training.trainer import build_optimizer as jax_build_optimizer
from supervised_dispnet_tpu_torch.utils.convert import (
    dispnet_from_jax, dispresnet_from_jax, posexpnet_from_jax)
from tests.test_torch_parallel import (
    AUG, B, H, LR, W, _batch, hold_running_stats, jax_draws, run_jax_steps, step_rngs,
    update_gap)
from tests.torch_ranks import start
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

DEPTH, K, R = 18, 16, 2
SELFSUP_WEIGHTS = {"photo_weight": 1.0, "mask_weight": 0.2, "smooth_weight": 0.1}
SELFSUP = {"selfsup mask 0": {"mask_weight": 0.0},
           "selfsup stochastic 2": {"stochastic_photo": 2}}
ENCODERS = ("disp.encoder.", "disp.conv", "pose.conv")


def _snippets(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    Kmat = np.array([[50.0, 0, W / 2 - 0.5], [0, 51.0, H / 2 + 0.5], [0, 0, 1]], np.float32)
    return {"tgt": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
            "ref_imgs": rng.integers(0, 256, (B, R, H, W, 3), dtype=np.uint8),
            "intrinsics": np.tile(Kmat, (B, 1, 1))}


def hold_updates(got: dict, ref: dict, init: dict, heads: float = 1e-2) -> None:
    """Each decoder and head tensor's update within ``heads`` of JAX's, the
    encoders' as a whole within 0.1 (``update_gap``)."""
    enc = [n for n in ref if n.startswith(ENCODERS)]
    for n in ref:
        if n not in enc and float((ref[n] - init[n]).norm()) > 0:
            gap = update_gap(got, ref, init, [n])
            assert gap <= heads, (n, gap)
    gap = update_gap(got, ref, init, enc)
    assert gap <= 0.1, ("encoders", gap)


def hold_update_direction(got: dict, ref: dict, init: dict) -> None:
    """QAT: the update of the encoder as a whole at cosine >= 0.7 with JAX's,
    of the decoder and heads at >= 0.95, each norm within 0.9..1.1."""
    for part, least in ((True, 0.7), (False, 0.95)):
        names = [n for n in ref if n.startswith(ENCODERS) == part]
        u = torch.cat([(ref[n] - init[n]).flatten() for n in names])
        g = torch.cat([(got[n] - init[n]).flatten() for n in names])
        cos, ratio = float(g @ u / (g.norm() * u.norm())), float(g.norm() / u.norm())
        assert cos >= least and 0.9 <= ratio <= 1.1, (part, cos, ratio)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks run the train cases while JAX compiles: every JAX
    step's draws (and the stochastic arm's phases) follow from the state's
    rng before any step runs (``step_rngs``); the self-supervised
    validation, which takes JAX's weights after the last run, is handed to
    the ranks last."""
    mesh = jax_make_mesh(jax.devices()[:2])
    cases, refs, jax_runs = {}, {}, {}

    def sup_draws(rng):
        return jax_draws(jax.random.split(rng)[1], AUG, B, H, W)

    def ss_draws(rng):
        return jax_draws(jax.random.split(rng, 3)[1], AUG, B, H, W)

    def ss_phases(rng):
        photo_key = jax.random.split(rng, 3)[2]
        return tuple(tuple(int(v) for v in jax.random.randint(
            jax.random.fold_in(photo_key, s), (2,), 0, 2)) for s in range(4))

    # multi-scale classification
    bins = jax_cls.DepthBins(num_bins=K)
    model = JaxDispResNet(encoder_depth=DEPTH, head="classification", num_bins=K,
                          multiscale_classification=True)
    st0 = create_train_state(model, (jnp.zeros((B, H, W, 3)),), optax.adam(LR), seed=0)

    def cls_sd(st):
        return {f"disp.{k}": v for k, v in dispresnet_from_jax(
            jax.device_get(st.params["disp"]), jax.device_get(st.batch_stats["disp"]), DEPTH,
            "classification", True).items()}

    batches = [_batch(10), _batch(11)]
    init = cls_sd(st0)
    draws = [sup_draws(r) for r in step_rngs(st0.rng, len(batches))]
    cases["classification"] = {
        "kind": "supervised", "loss": "classification", "lr": LR, "batches": batches,
        "draws": draws, "model": {"depth": DEPTH, "head": "classification", "num_bins": K,
                                  "multiscale": True},
        "state_dict": {k.removeprefix("disp."): v for k, v in init.items()}}
    refs["classification"] = {"init": init}
    jax_runs["classification"] = (
        lambda: jax_make_step(model, "classification", bins=bins, aug=AUG, donate=False,
                              mesh=mesh), st0, batches, sup_draws, draws, cls_sd)

    # BerHu with QAT, EMA and 2 micro-batches an update
    smodel = JaxDispResNet(encoder_depth=DEPTH)
    tx = jax_build_optimizer(JaxTrainerConfig(lr=LR, accum_steps=2))
    sst0 = create_train_state(smodel, (jnp.zeros((B, H, W, 3)),), tx, seed=0, ema=True)

    def sup_sd(params, stats):
        return {f"disp.{k}": v for k, v in dispresnet_from_jax(
            jax.device_get(params), jax.device_get(stats), DEPTH).items()}

    batches = [_batch(20 + i) for i in range(2)]
    init = sup_sd(sst0.params["disp"], sst0.batch_stats["disp"])
    draws = [sup_draws(r) for r in step_rngs(sst0.rng, len(batches))]
    cases["qat ema accum"] = {
        "kind": "supervised", "loss": "berhu", "lr": LR, "batches": batches, "draws": draws,
        "model": {"depth": DEPTH}, "opts": {"fake_quant": True, "ema_decay": 0.9,
                                            "accum_steps": 2},
        "state_dict": {k.removeprefix("disp."): v for k, v in init.items()}}
    refs["qat ema accum"] = {"init": init}
    jax_runs["qat ema accum"] = (
        lambda: jax_make_step(smodel, "berhu", aug=AUG, donate=False, mesh=mesh,
                              fake_quant=True, ema_decay=0.9, accum_steps=2),
        sst0, batches, sup_draws, draws, None)

    # self-supervised, with the explainability head unused, then with it and
    # the stochastic photometric arm
    dmodel, pmodel = JaxDispNetS(), JaxPoseExpNet(nb_ref_imgs=R)
    zeros = jnp.zeros((B, H, W, 3))
    pst0 = create_train_state(dmodel, (zeros,), optax.adam(LR), seed=0,
                              extra_models={"pose": (pmodel, (zeros, [zeros] * R))})
    params = jax.device_get(pst0.params)
    # a pose of ~1e-2, off whole pixels (tests/test_torch_selfsup_step.py)
    params["pose"]["pose_pred"]["bias"] = np.random.default_rng(1).normal(
        0.0, 2.0, (6 * R,)).astype(np.float32)
    pst0 = pst0.replace(params=jax.tree.map(jnp.asarray, params))

    def ss_sd(p):
        p = jax.device_get(p)
        return {**{f"disp.{k}": v for k, v in dispnet_from_jax(p["disp"]).items()},
                **{f"pose.{k}": v for k, v in posexpnet_from_jax(p["pose"]).items()}}

    batches = [_snippets(30), _snippets(31)]
    rngs = step_rngs(pst0.rng, len(batches), parts=3)
    init = ss_sd(pst0.params)
    for name, opts in SELFSUP.items():
        weights = {**SELFSUP_WEIGHTS, **{k: v for k, v in opts.items() if k.endswith("weight")}}
        arm = {k: v for k, v in opts.items() if not k.endswith("weight")}
        draws = [ss_draws(r) for r in rngs]
        cases[name] = {"kind": "selfsup", "refs": R, "weights": weights, "opts": arm,
                       "lr": LR, "batches": batches, "draws": draws,
                       "phases": [ss_phases(r) for r in rngs] if arm else [],
                       "pose_exp": True,
                       "disp_sd": {k[5:]: v for k, v in init.items() if k[:5] == "disp."},
                       "pose_sd": {k[5:]: v for k, v in init.items() if k[:5] == "pose."}}
        refs[name] = {"init": init}
        jax_runs[name] = (
            lambda weights=weights, arm=arm: jax_make_selfsup_step(
                dmodel, pmodel, nb_ref_imgs=R, aug=AUG, donate=False, mesh=mesh, **weights,
                **arm), pst0, batches, ss_draws, draws, None)

    cases["classification spatial"] = {**cases["classification"], "spatial": 2}
    refs["classification spatial"] = refs["classification"]
    ranks = start(cases, tmp_path_factory.mktemp("ranks"))
    # 2 data x 2 spatial ranks
    ranks4 = start({"classification 2x2": cases["classification spatial"]},
                   tmp_path_factory.mktemp("ranks4"), world=4)
    ranks4.late({})
    try:
        for name, (make, state, batches, draws_of, draws, to_sd) in jax_runs.items():
            st, losses, ran = run_jax_steps(make(), state, batches, mesh, draws_of)
            assert all(np.array_equal(a[k], b[k]) for a, b in zip(ran, draws) for k in a)
            refs[name]["losses"] = losses
            if name == "qat ema accum":
                refs[name]["state"] = sup_sd(st.params["disp"], st.batch_stats["disp"])
                refs[name]["ema"] = sup_sd(st.ema_params["disp"], st.batch_stats["disp"])
            else:
                refs[name]["state"] = (to_sd or ss_sd)(st if to_sd else st.params)
        # the self-supervised validation step, from the last run's weights
        val = _snippets(32)
        ref_eval = jax_make_selfsup_eval(dmodel, pmodel, nb_ref_imgs=R, aug=AUG, mesh=mesh)(
            st.params, st.batch_stats, jax_shard_batch(
                {k: jnp.asarray(v) for k, v in val.items()}, mesh))
        refs["selfsup eval"] = {k: float(v) for k, v in ref_eval.items()}
    except BaseException:
        ranks.kill()
        ranks4.kill()
        raise
    trained = ss_sd(st.params)
    ranks.late({"selfsup eval": {
        "kind": "selfsup_eval", "refs": R, "weights": SELFSUP_WEIGHTS, "batches": [val],
        "disp_sd": {k[5:]: v for k, v in trained.items() if k[:5] == "disp."},
        "pose_sd": {k[5:]: v for k, v in trained.items() if k[:5] == "pose."}}})
    return {"ranks": ranks.wait(), "ranks4": ranks4.wait(), "refs": refs}


def _check(runs, name: str) -> tuple[dict, dict]:
    ref = runs["refs"][name]
    r0, r1 = (r[name] for r in runs["ranks"])
    assert "raised" not in r0 and "raised" not in r1, r0.get("raised")
    assert r0["digest"] == r1["digest"]
    for r in (r0, r1):
        assert len(r["metrics"]) == len(ref["losses"])
        for i, (got, want) in enumerate(zip(r["metrics"], ref["losses"])):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           err_msg=f"{k}, step {i + 1}")
    return r0, ref


def test_multiscale_classification_matches_the_jax_mesh_step(runs):
    r0, ref = _check(runs, "classification")
    got = {k: v for k, v in r0["state"].items() if k in ref["state"]}
    assert hold_running_stats(got, ref["state"]) > 0
    hold_updates(got, {k: v for k, v in ref["state"].items() if "running_" not in k and
                       "num_batches" not in k}, ref["init"])


def test_multiscale_classification_on_a_spatial_mesh_matches_the_jax_mesh_step(runs):
    r0, ref = _check(runs, "classification spatial")
    got = {k: v for k, v in r0["state"].items() if k in ref["state"]}
    assert hold_running_stats(got, ref["state"]) > 0
    hold_updates(got, {k: v for k, v in ref["state"].items() if "running_" not in k and
                       "num_batches" not in k}, ref["init"])


def test_multiscale_classification_on_a_two_by_two_mesh_matches_the_jax_mesh_step(runs):
    """4 ranks, 2 data x 2 spatial, against the same JAX step; the four
    ranks hold the same state bit for bit."""
    ref = runs["refs"]["classification"]
    r = [x["classification 2x2"] for x in runs["ranks4"]]
    assert not [x["raised"] for x in r if "raised" in x]
    assert len({x["digest"] for x in r}) == 1
    for x in r:
        np.testing.assert_allclose([m["loss"] for m in x["metrics"]],
                                   [m["loss"] for m in ref["losses"]], rtol=1e-4)
    got = {k: v for k, v in r[0]["state"].items() if k in ref["state"]}
    assert hold_running_stats(got, ref["state"]) > 0
    hold_updates(got, {k: v for k, v in ref["state"].items() if "running_" not in k and
                       "num_batches" not in k}, ref["init"])


def test_qat_ema_and_accumulation_match_the_jax_mesh_step(runs):
    """2 micro-steps, 1 update: the loss of each micro-step, the update of
    the parameters and of the EMA shadow, the statistics."""
    r0, ref = _check(runs, "qat ema accum")
    params = {k: v for k, v in ref["state"].items() if "running_" not in k and
              "num_batches" not in k}
    hold_update_direction(r0["state"], params, ref["init"])
    ema = {f"disp.{k}": v for k, v in r0["ema"].items()}
    hold_update_direction(ema, {k: ref["ema"][k] for k in params}, ref["init"])
    assert hold_running_stats(r0["state"], ref["state"], limit=5e-2) > 0


@pytest.mark.parametrize("name", sorted(SELFSUP))
def test_selfsup_matches_the_jax_mesh_step(runs, name):
    """The loss and its three terms at each step, both nets' parameters; with
    ``mask_weight`` 0 the explainability head takes no gradient and stays
    where it was on both sides."""
    r0, ref = _check(runs, name)
    hold_updates(r0["state"], ref["state"], ref["init"], heads=5e-2)
    head = [k for k in ref["state"] if k.startswith(("pose.upconv", "pose.predict_mask"))]
    assert head
    if name == "selfsup mask 0":
        for k in head:
            assert torch.equal(r0["state"][k], ref["init"][k]), k
            assert torch.equal(ref["state"][k], ref["init"][k]), k


def test_selfsup_eval_step_matches_the_jax_mesh(runs):
    ref = runs["refs"]["selfsup eval"]
    for r in runs["ranks"]:
        got = r["selfsup eval"]["metrics"][0]
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
