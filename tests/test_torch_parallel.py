"""Data-parallel training of the port (``parallel/mesh.py``) on the CPU:
two gloo ranks (``tests/torch_ranks.py``) against the JAX package's step on
a mesh of 2 of its virtual CPU devices, for the supervised losses, and
against one process of the port; the mesh's helpers; a batch the ranks do
not divide; a NaN on one rank. The same two ranks as one spatial group
(``--spatial-shards 2``, ``parallel/spatial.py``: each takes half the image
rows of the whole batch), and 4 ranks as 2 data x 2 spatial, against the
same JAX steps and validation, with the same tolerances (measured: BN
statistics <= 9.3e-5, decoder and heads <= 1.5e-3, encoders <= 4.7e-2):
JAX's data mesh computes what its ``(data, spatial)`` mesh does
(``tests/test_spatial.py`` holds the two equal), and one compile serves
all three losses. BerHu's steps also run on JAX's own 1 x 2 ``(data,
spatial)`` mesh, and the 2 spatial ranks are held to them the same way
(``test_a_spatial_mesh_matches_the_jax_spatial_mesh_step``).

DispResNet-18 at 64x96, a global batch of 4 (2 rows a rank), the default
augmentation: JAX's steps draw it from their key and the port's ranks are
handed the same draws for the global batch (``draws=``), of which each
keeps its rows. Tolerances: the loss rtol 1e-4 at each of 2 Adam steps (as
``tests/test_torch_train_step.py`` holds one process to JAX); after them
BatchNorm's running statistics rel-L2 1e-3 a tensor (measured 9.2e-5), each
decoder and head tensor within 1e-2 of JAX's update (``update_gap``;
measured 2.0e-3) and the encoder as a whole within 0.1 (ROADMAP C4: Adam's
first updates, about lr * sign(g), take the sign of gradient entries that
rounding decides, and the encoder's carry the most; one tensor alone parts
by up to 0.13); the validation metrics rtol 1e-4 / atol 1e-6. Two ranks
against one rank of the port (each drawing its own augmentation from the
same seed): one step's loss, each decoder and head gradient and every
running statistic within 1e-5 (rel-L2 a tensor): the ranks' rows of the
global draws line up row for row. The encoder's gradient is held as a
whole, at cosine >= 1 - 1e-6 with the one process's (measured 1 - 6.2e-8)
and a norm within 2e-5 (measured 2.0e-6); its tensors part by up to 6.6e-4:
the one process takes BatchNorm's statistics in ``F.batch_norm`` and the
ranks by the mesh's formula (``models/common.py``), whose roundings differ
by ~1e-7, and an activation within rounding of a ReLU's kink takes a side
by them (in a float64 run of this network on a random input,
``F.batch_norm``'s float32 rounding put one activation on the other side
of its ReLU from float64's and the mesh formula's); every gradient
upstream of the kink then carries the difference. ``tests/test_torch_spatial.py`` holds one BatchNorm on the
mesh path to ``F.batch_norm`` (output and every gradient, 1e-5) and its
variance to the float64 one on both paths."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from supervised_dispnet_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from supervised_dispnet_tpu.models import DispResNet as JaxDispResNet
from supervised_dispnet_tpu.parallel import make_mesh as jax_make_mesh
from supervised_dispnet_tpu.parallel import shard_batch as jax_shard_batch
from supervised_dispnet_tpu.training import (
    create_train_state, make_eval_step as jax_make_eval_step,
    make_supervised_train_step as jax_make_step)
from supervised_dispnet_tpu_torch.models import DispResNet
from supervised_dispnet_tpu_torch.parallel import mesh as pm
from supervised_dispnet_tpu_torch.training.trainer import Trainer, TrainerConfig
from supervised_dispnet_tpu_torch.utils.convert import dispresnet_from_jax
from tests.torch_ranks import run_case, start
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

DEPTH, B, H, W = 18, 4, 64, 96
LR = 1e-3
AUG = JaxAugmentConfig()
LOSSES = ("berhu", "l1", "scale_invariant")


def jax_draws(key, config: JaxAugmentConfig, n: int, h: int, w: int) -> dict:
    """The random numbers the JAX ``augment_batch`` draws from ``key`` for
    a batch of ``n`` (its recipe, as ``tests/test_torch_augment.py``)."""
    k_scale, k_ox, k_oy, k_flip, k_b, k_c, k_s = jax.random.split(key, 7)
    f32 = jnp.float32
    sc = jax.random.uniform(k_scale, (n, 2), f32, 1.0, config.max_scale)
    sx, sy = sc[:, 0], sc[:, 1]
    draws = {"scale_x": sx, "scale_y": sy,
             "ox": jax.random.uniform(k_ox, (n,), f32) * (sx - 1.0) * w,
             "oy": jax.random.uniform(k_oy, (n,), f32) * (sy - 1.0) * h,
             "flip": jax.random.bernoulli(k_flip, 0.5, (n,))}
    for name, k, a in (("brightness", k_b, config.brightness),
                       ("contrast", k_c, config.contrast),
                       ("saturation", k_s, config.saturation)):
        draws[name] = jax.random.uniform(k, (n, 1, 1, 1, 1), f32, 1.0 - a, 1.0 + a)
    return {k: np.array(v).reshape(n) for k, v in draws.items()}


def _batch(seed: int, n: int = B) -> dict:
    rng = np.random.default_rng(seed)
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    depth = rng.uniform(1.0, 60.0, (n, H, W)) * (rng.uniform(size=(n, H, W)) < 0.3)
    return {"tgt": rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8),
            "intrinsics": np.tile(K, (n, 1, 1)),
            "depth": depth.astype(np.float16)}


def step_rngs(rng, steps: int, parts: int = 2) -> list:
    """The rng each of ``steps`` JAX steps starts from: a step splits its
    rng into ``parts`` and keeps the first (the supervised step 2, the
    self-supervised 3); so the draws of every step are known before any
    step runs."""
    out = []
    for _ in range(steps):
        out.append(rng)
        rng = jax.random.split(rng, parts)[0]
    return out


def run_jax_steps(step, state, batches, mesh, draws_of) -> tuple:
    """The JAX mesh step over ``batches``; returns the final state, the
    metrics and the draws of each step (recomputed from its key by
    ``draws_of``)."""
    losses, draws = [], []
    for batch in batches:
        draws.append(draws_of(state.rng))
        state, metrics = step(state, jax_shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, mesh))
        losses.append({k: float(v) for k, v in metrics.items()})
    return state, losses, draws


def update_gap(got: dict, ref: dict, init: dict, names) -> float:
    """||got - ref|| / ||ref - init|| over ``names`` at once: how far the
    port's parameters lie from JAX's, as a share of how far JAX's steps
    moved them."""
    d = torch.cat([(got[n] - ref[n]).flatten() for n in names])
    u = torch.cat([(ref[n] - init[n]).flatten() for n in names])
    return float(d.norm() / u.norm())


def hold_params_after_adam(got: dict, ref: dict, init: dict, names) -> None:
    """The parameters after the Adam steps: each decoder and head tensor
    within 1e-2 of JAX's update (``update_gap``), the encoder as a whole
    within 0.1 (ROADMAP C4: Adam's update is about lr * sign(g), and the
    encoder's gradients carry entries whose sign rests on rounding)."""
    enc = [n for n in names if n.startswith("encoder.")]
    for n in names:
        if n not in enc:
            gap = update_gap(got, ref, init, [n])
            assert gap <= 1e-2, (n, gap)
    gap = update_gap(got, ref, init, enc)
    assert gap <= 0.1, ("encoder", gap)


def hold_running_stats(got: dict, ref: dict, limit: float = 1e-3) -> int:
    """BatchNorm's running statistics, rel-L2 ``limit`` a tensor."""
    keys = [k for k in ref if "running_" in k]
    for k in keys:
        rel = float((got[k] - ref[k]).norm() / ref[k].norm())
        assert rel <= limit, (k, rel)
    return len(keys)


def nan_case() -> dict:
    """``debug_nans`` with a NaN in one row of the second batch (rank 1's)."""
    batch = _batch(3)
    nan = {**batch, "tgt": batch["tgt"].astype(np.float32) / 255.0}
    nan["tgt"][3, 0, 0, 0] = np.nan
    torch.manual_seed(0)
    return {"kind": "supervised", "model": {"depth": DEPTH},
            "state_dict": DispResNet(DEPTH).state_dict(), "loss": "l1", "lr": LR,
            "batches": [batch, nan], "draws": [None, None], "opts": {"debug_nans": True}}


@pytest.fixture(scope="module")
def supervised(tmp_path_factory):
    """Two ranks of the port and JAX's 2-device mesh step, 2 Adam steps of
    each supervised loss from the same weights on the same batches, then
    one validation step; one step of each on one rank of the port, its
    augmentation drawn from a generator, and on two ranks the same way; and
    the NaN case. The ranks run while JAX compiles (the draws of JAX's
    steps are known before they run, ``step_rngs``); the validation, which
    takes JAX's weights after BerHu's steps, is handed to them last."""
    mesh = jax_make_mesh(jax.devices()[:2])
    model = JaxDispResNet(encoder_depth=DEPTH)
    state0 = create_train_state(model, (jnp.zeros((B, H, W, 3)),), optax.adam(LR), seed=0)

    def to_sd(st):
        return dispresnet_from_jax(jax.device_get(st.params["disp"]),
                                   jax.device_get(st.batch_stats["disp"]), DEPTH)

    def draws_of(rng):
        return jax_draws(jax.random.split(rng)[1], AUG, B, H, W)

    batches = [_batch(0), _batch(1)]
    init = to_sd(state0)
    draws = [draws_of(rng) for rng in step_rngs(state0.rng, len(batches))]
    cases, refs, states = {}, {}, {}
    for loss in LOSSES:
        cases[loss] = {"kind": "supervised", "model": {"depth": DEPTH},
                       "state_dict": init, "loss": loss, "lr": LR,
                       "batches": batches, "draws": draws}
        cases[f"{loss} drawn"] = {**cases[loss], "batches": batches[:1], "draws": [None],
                                  "seed": 5, "grads": True}
    cases["nan"] = nan_case()
    for loss in LOSSES:
        cases[f"{loss} spatial"] = {**cases[loss], "spatial": 2}
    ranks = start(cases, tmp_path_factory.mktemp("ranks"))
    # 2 data x 2 spatial ranks: each loss's steps once more
    ranks4 = start({f"{loss} 2x2": {**cases[loss], "spatial": 2} for loss in LOSSES},
                   tmp_path_factory.mktemp("ranks4"), world=4)
    ranks4.late({})
    try:
        one = {n: run_case(c, pm.Mesh()) for n, c in cases.items() if n.endswith("drawn")}
        for loss in LOSSES:
            step = jax_make_step(model, loss, aug=AUG, donate=False, mesh=mesh)
            st, losses, ran = run_jax_steps(step, state0, batches, mesh, draws_of)
            assert all(np.array_equal(a[k], b[k]) for a, b in zip(ran, draws) for k in a)
            refs[loss] = {"losses": losses, "state": to_sd(st)}
            states[loss] = st
        # BerHu's steps once more on JAX's (data, spatial) mesh of 1 x 2
        smesh = jax_make_mesh(jax.devices()[:2], spatial=2)
        step = jax_make_step(model, "berhu", aug=AUG, donate=False, mesh=smesh)
        st, losses, _ = run_jax_steps(step, state0, batches, smesh, draws_of)
        refs["berhu (data, spatial)"] = {"losses": losses, "state": to_sd(st)}
        # validation after BerHu's steps, with its weights and statistics
        val = _batch(2)
        val = {"img": val["tgt"], "depth": val["depth"]}
        berhu_state = states["berhu"]
        ref_eval = jax_make_eval_step(model, aug=AUG, mesh=mesh)(
            berhu_state.params, berhu_state.batch_stats,
            jax_shard_batch({k: jnp.asarray(v) for k, v in val.items()}, mesh))
        refs["eval"] = {k: float(v) for k, v in ref_eval.items()}
    except BaseException:
        ranks.kill()
        ranks4.kill()
        raise
    evaluate = {"kind": "eval", "model": {"depth": DEPTH}, "state_dict": to_sd(berhu_state),
                "batches": [val]}
    ranks.late({"eval": evaluate, "eval spatial": {**evaluate, "spatial": 2}})
    return {"ranks": ranks.wait(), "ranks4": ranks4.wait(), "refs": refs, "one": one,
            "init": init}


@pytest.mark.parametrize("loss", LOSSES)
def test_two_ranks_match_the_jax_mesh_step(supervised, loss):
    """Both ranks' losses, parameters after 2 Adam steps and BN running
    statistics against JAX's 2-device mesh step; the two ranks hold the
    same state bit for bit."""
    ref = supervised["refs"][loss]
    r0, r1 = (r[loss] for r in supervised["ranks"])
    assert "raised" not in r0 and "raised" not in r1
    for r in (r0, r1):
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]],
                                   [m["loss"] for m in ref["losses"]], rtol=1e-4)
    assert r0["digest"] == r1["digest"]
    names = [n for n, _ in DispResNet(DEPTH).named_parameters()]
    got = {n.removeprefix("disp."): v for n, v in r0["state"].items()}
    assert hold_running_stats(got, ref["state"]) > 0
    hold_params_after_adam(got, ref["state"], supervised["init"], names)


@pytest.mark.parametrize("loss", LOSSES)
def test_a_spatial_mesh_matches_the_jax_mesh_step(supervised, loss):
    """2 spatial ranks (a 1 x 2 mesh: the whole batch, half the rows each)
    against JAX's step, as ``test_two_ranks_match_the_jax_mesh_step``
    (measured: decoder and heads <= 1.3e-3, BN statistics <= 8.3e-5)."""
    ref = supervised["refs"][loss]
    r0, r1 = (r[f"{loss} spatial"] for r in supervised["ranks"])
    assert "raised" not in r0 and "raised" not in r1, r0.get("raised")
    for r in (r0, r1):
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]],
                                   [m["loss"] for m in ref["losses"]], rtol=1e-4)
    assert r0["digest"] == r1["digest"]
    got = {n.removeprefix("disp."): v for n, v in r0["state"].items()}
    assert hold_running_stats(got, ref["state"]) > 0
    hold_params_after_adam(got, ref["state"], supervised["init"],
                           [n for n, _ in DispResNet(DEPTH).named_parameters()])


def test_a_spatial_mesh_matches_the_jax_spatial_mesh_step(supervised):
    """The same 2 spatial ranks' BerHu steps against JAX's own ``(data,
    spatial)`` mesh of 1 x 2 (``make_mesh(jax.devices()[:2], spatial=2)``),
    with the tolerances of ``test_two_ranks_match_the_jax_mesh_step``
    (measured: the loss 3.7e-6, decoder and heads <= 1.1e-3, BN statistics
    <= 5.1e-5, the encoder 1.4e-2; JAX's two meshes' decoder and heads part
    by 7.8e-4 here). At H = 64 the deepest map holds one row a shard, where
    GSPMD's own gradients part from one device's by ~1e-4
    (``tests/test_spatial.py``); JAX's 2 x 2 ``(data, spatial)`` mesh
    (``[:4]``) parts from its data mesh and its 1 x 2 mesh by 3.7e-4 in the
    second step's loss there, where the port's 2 x 2 ranks part from both
    by 3.5e-6, so they are held to the data mesh. One loss only, to keep the
    suite's time."""
    ref = supervised["refs"]["berhu (data, spatial)"]
    r0, r1 = (r["berhu spatial"] for r in supervised["ranks"])
    for r in (r0, r1):
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]],
                                   [m["loss"] for m in ref["losses"]], rtol=1e-4)
    got = {n.removeprefix("disp."): v for n, v in r0["state"].items()}
    assert hold_running_stats(got, ref["state"]) > 0
    hold_params_after_adam(got, ref["state"], supervised["init"],
                           [n for n, _ in DispResNet(DEPTH).named_parameters()])


@pytest.mark.parametrize("loss", LOSSES)
def test_a_two_by_two_mesh_matches_the_jax_mesh_step(supervised, loss):
    """4 ranks, 2 data x 2 spatial (each 2 batch rows, half the image rows),
    against JAX's step, as ``test_two_ranks_match_the_jax_mesh_step``
    (measured: decoder and heads <= 1.5e-3, BN statistics <= 9.3e-5). The
    four ranks hold the same state bit for bit."""
    ref = supervised["refs"][loss]
    runs = [r[f"{loss} 2x2"] for r in supervised["ranks4"]]
    assert not [r["raised"] for r in runs if "raised" in r]
    for r in runs:
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]],
                                   [m["loss"] for m in ref["losses"]], rtol=1e-4)
    assert len({r["digest"] for r in runs}) == 1
    got = {n.removeprefix("disp."): v for n, v in runs[0]["state"].items()}
    assert hold_running_stats(got, ref["state"]) > 0
    hold_params_after_adam(got, ref["state"], supervised["init"],
                           [n for n, _ in DispResNet(DEPTH).named_parameters()])


def _hold_eval(supervised, case: str) -> None:
    ref = supervised["refs"]["eval"]
    for r in supervised["ranks"]:
        got = r[case]["metrics"][0]
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_two_ranks_eval_step_matches_the_jax_mesh(supervised):
    _hold_eval(supervised, "eval")


def test_a_spatial_mesh_eval_step_matches_the_jax_mesh(supervised):
    """The eval step on 2 spatial ranks (metrics rtol 1e-4, as
    ``tests/test_spatial.py`` holds JAX's)."""
    _hold_eval(supervised, "eval spatial")


@pytest.mark.parametrize("loss", LOSSES)
def test_two_ranks_match_one_rank_with_drawn_augmentation(supervised, loss):
    """One step on 2 ranks against one process of the port, each drawing
    the augmentation from a generator seeded alike: the rows of the global
    draws line up, so the loss, the decoder's and heads' gradients and the
    statistics agree to rounding (rtol 1e-5), and the encoder's gradient as
    a whole points the same way (module docstring)."""
    one = supervised["one"][f"{loss} drawn"]
    two, other = (r[f"{loss} drawn"] for r in supervised["ranks"])
    assert two["digest"] == other["digest"]
    for r in (two, other):
        np.testing.assert_allclose(r["metrics"][0]["loss"], one["metrics"][0]["loss"],
                                   rtol=1e-5)
    assert set(two["grads"]) == set(one["grads"])
    enc = [n for n in one["grads"] if n.startswith("disp.encoder.")]
    for n, g in one["grads"].items():
        if n not in enc:
            rel = float((two["grads"][n] - g).norm() / g.norm().clamp(min=1e-30))
            assert rel <= 1e-5, (n, rel)
    u = torch.cat([one["grads"][n].flatten() for n in enc]).double()
    v = torch.cat([two["grads"][n].flatten() for n in enc]).double()
    cos, ratio = float(u @ v / (u.norm() * v.norm())), float(v.norm() / u.norm())
    assert cos >= 1 - 1e-6 and abs(ratio - 1) <= 2e-5, (cos, ratio)
    for n, v in one["state"].items():
        if "running_" in n:
            rel = float((two["state"][n] - v).norm() / v.norm().clamp(min=1e-30))
            assert rel <= 1e-5, (n, rel)


def test_ranks_import_neither_jax_nor_the_jax_package(supervised):
    for r in supervised["ranks"]:
        bad = [m for m in r["modules"] if m in ("jax", "jaxlib", "flax", "optax")
               or m.startswith(("jax.", "jaxlib.", "flax.", "optax."))
               or m.split(".")[0] == "supervised_dispnet_tpu"]
        assert bad == []


def test_a_mesh_of_one_rank_reduces_nothing():
    """Without a process group the mesh has one rank, its rows are the
    whole batch, and every reduction returns its input."""
    mesh = pm.make_mesh()
    assert (mesh.size, mesh.rank, mesh.rows(4)) == (1, 0, slice(0, 4))
    x = torch.arange(3.0, requires_grad=True)
    with pm.use_mesh(mesh):
        assert pm.active_mesh() is None
        assert pm.all_reduce_sum(x) is x and pm.all_reduce_max(x) is x
        assert pm.global_sums(x[0], x[1]) == (x[0], x[1])
    assert pm.spatial_size(mesh) == 1


def test_mesh_rows_and_backend_rule():
    assert [pm.Mesh(size=4, rank=r).rows(8) for r in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="6.*4 ranks"):
        pm.Mesh(size=4, rank=0).rows(6)
    assert pm.choose_backend("cuda", 4, 4) == "nccl"
    assert pm.choose_backend("cuda", 2, 1) == "gloo"  # two ranks share a card
    assert pm.choose_backend("cpu", 2, 0) == "gloo"
    assert pm.choose_backend("cuda", 1, 8) == "nccl"


def test_the_spatial_axis_still_raises():
    """What the spatial axis does not take: a world that its shards do not
    divide (``ValueError``), and the self-supervised step (A6b-2)."""
    with pytest.raises(ValueError, match="spatial partitioning"):
        pm.make_mesh(spatial=2)
    from supervised_dispnet_tpu_torch.models import DispNetS, PoseExpNet
    from supervised_dispnet_tpu_torch.training.train_step import make_selfsup_train_step

    disp = DispNetS()
    with pytest.raises(NotImplementedError, match="A6b-2"):
        make_selfsup_train_step(disp, PoseExpNet(), torch.optim.Adam(disp.parameters()),
                                mesh=pm.Mesh(size=2, spatial=2))


def test_a_batch_the_ranks_do_not_divide_raises():
    """The trainer names the global batch and the ranks; so does a step's
    row split (a batch of 3 on 2 ranks: the draws of 6 rows on 4)."""
    with pytest.raises(ValueError, match="--batch-size 3 .* 2 ranks"):
        Trainer(TrainerConfig(batch_size=3), DispResNet(18), device="cpu",
                mesh=pm.Mesh(size=2))
    with pytest.raises(ValueError, match="6 is not divisible by the 4 ranks"):
        pm.Mesh(size=4).rows(6)


def test_a_nan_on_one_rank_raises_on_both(supervised):
    """``debug_nans``: a NaN in one row of the global batch (rank 1's)
    reaches both ranks through the global statistics and the averaged
    gradients; both raise ``FloatingPointError`` at the same step, within
    the spawn's deadline (and go on to the next case)."""
    for r in supervised["ranks"]:
        assert len(r["nan"]["metrics"]) == 1
        assert r["nan"]["raised"].startswith("FloatingPointError"), r["nan"].get("raised")
        assert "at train step 1 (update 1)" in r["nan"]["raised"]
