"""One depth-as-classification train step of the port against the JAX
package's ``make_supervised_train_step(model, "classification", bins=...)``
on the CPU in fp32, single- and multi-scale (the JAX CE is the XLA loss;
``test_torch_classification.py`` holds the CE against the interpret-mode
Pallas op as well): DispResNet-18
with 16 bins at 64x96, B=2, augmentation off, the same weights carried
across with ``dispresnet_from_jax``, the same uint8 images and fp16 depth.
Then the validation step, and a two-step ``--loss classification`` CLI run."""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from supervised_dispnet_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from supervised_dispnet_tpu.data.augment import augment_batch as jax_augment_batch
from supervised_dispnet_tpu.losses import classification as jax_cls
from supervised_dispnet_tpu.models import DispResNet as JaxDispResNet
from supervised_dispnet_tpu.training import (
    create_train_state, make_eval_step as jax_make_eval_step,
    make_supervised_train_step as jax_make_step)
from supervised_dispnet_tpu_torch.cli import train as train_cli
from supervised_dispnet_tpu_torch.data.augment import AugmentConfig
from supervised_dispnet_tpu_torch.data.packed import write_split
from supervised_dispnet_tpu_torch.losses.classification import DepthBins
from supervised_dispnet_tpu_torch.models import DispResNet
from supervised_dispnet_tpu_torch.ops.cuda import classification as kc
from supervised_dispnet_tpu_torch.training.train_step import (
    make_eval_step, make_supervised_train_step)
from supervised_dispnet_tpu_torch.training.trainer import (
    BEST_NAME, CHECKPOINT_NAME, TrainerConfig, build_optimizer)
from supervised_dispnet_tpu_torch.utils.convert import dispresnet_from_jax
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

DEPTH, K, B, H, W = 18, 16, 2, 64, 96
LR = 1e-3
JAX_NO_AUG = JaxAugmentConfig(flip=False, scale_crop=False, color_jitter=False)
NO_AUG = AugmentConfig(flip=False, scale_crop=False, color_jitter=False)
JAX_BINS = jax_cls.DepthBins(num_bins=K)
BINS = DepthBins(num_bins=K)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    K3 = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    depth = rng.uniform(0.5, 90.0, (B, H, W)) * (rng.uniform(size=(B, H, W)) < 0.3)
    return {"tgt": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
            "intrinsics": np.tile(K3, (B, 1, 1)),
            "depth": depth.astype(np.float16)}


@pytest.fixture(scope="module", params=[False, True], ids=["single", "multiscale"])
def one_step(request):
    """Both steps from the same weights on the same batch."""
    multi = request.param
    model = JaxDispResNet(encoder_depth=DEPTH, head="classification", num_bins=K,
                          multiscale_classification=multi)
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
        out, _ = model.apply({"params": params, "batch_stats": state.batch_stats["disp"]},
                             imgs[:, 0], train=True, mutable=["batch_stats"])
        if multi:
            return jax_cls.multiscale_classification_loss(out, depth, mask, JAX_BINS)
        return jax_cls.depth_classification_loss(out, depth, mask, JAX_BINS)

    ref_loss_fn, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(state.params["disp"])
    step = jax_make_step(model, "classification", bins=JAX_BINS, aug=JAX_NO_AUG,
                         donate=False)
    new_state, metrics = step(state, jbatch)
    params0 = jax.device_get(state.params["disp"])
    stats0 = jax.device_get(state.batch_stats["disp"])

    def to_sd(params, stats):
        return dispresnet_from_jax(jax.device_get(params), jax.device_get(stats), DEPTH,
                                   "classification", multi)

    port = DispResNet(DEPTH, head="classification", num_bins=K,
                      multiscale_classification=multi)
    port.load_state_dict(to_sd(params0, stats0), strict=True)
    opt = build_optimizer(TrainerConfig(lr=LR), port.parameters())
    port_step = make_supervised_train_step(port, opt, "classification", bins=BINS, aug=NO_AUG)
    launches = (kc.ce_fwd_launches, kc.ce_bwd_launches)
    out = port_step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert (kc.ce_fwd_launches, kc.ce_bwd_launches) == launches
    return {"ref_loss": float(metrics["loss"]), "ref_loss_fn": float(ref_loss_fn),
            "ref_grads": to_sd(ref_grads, stats0),
            "ref_new": to_sd(new_state.params["disp"], new_state.batch_stats["disp"]),
            "loss": float(out["loss"]), "port": port, "new_state": new_state,
            "model": model}


def test_classification_step_loss_matches_jax(one_step):
    assert one_step["ref_loss"] == pytest.approx(one_step["ref_loss_fn"], rel=1e-6)
    np.testing.assert_allclose(one_step["loss"], one_step["ref_loss"], rtol=1e-4)


def test_classification_step_gradients_match_jax(one_step):
    """Every parameter's gradient, rtol 1e-3 / atol 1e-5 (convolutions sum
    in another order in XLA and in PyTorch), bin heads included."""
    names = [n for n, _ in one_step["port"].named_parameters()]
    assert len(names) == len([k for k in one_step["ref_grads"] if "running_" not in k])
    assert "predict_class.0.weight" in names
    for name, p in one_step["port"].named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), one_step["ref_grads"][name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_classification_step_batchnorm_stats_match_jax(one_step):
    sd = one_step["port"].state_dict()
    keys = [k for k in one_step["ref_new"] if "running_" in k]
    assert keys
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), one_step["ref_new"][k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_classification_step_adam_update_matches_optax(one_step):
    """Parameters after the first Adam update, atol 1e-6, on entries whose
    gradient is above 1e-5 (the first update is about lr * sign(g))."""
    for name, p in one_step["port"].named_parameters():
        g = one_step["ref_grads"][name].numpy()
        sel = np.abs(g) > 1e-5
        np.testing.assert_allclose(p.detach().numpy()[sel],
                                   one_step["ref_new"][name].numpy()[sel],
                                   rtol=0, atol=1e-6, err_msg=name)


def test_classification_eval_step_matches_jax(one_step):
    """Validation after the update: the finest logits' soft decode against
    GT, Eigen metrics rtol 1e-4; no CE kernel is launched."""
    rng = np.random.default_rng(1)
    depth = rng.uniform(1.0, 60.0, (B, H, W)) * (rng.uniform(size=(B, H, W)) < 0.3)
    batch = {"img": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
             "depth": depth.astype(np.float16)}
    st = one_step["new_state"]
    ref = jax_make_eval_step(one_step["model"], classification=True, bins=JAX_BINS,
                             aug=JAX_NO_AUG)(
        st.params, st.batch_stats, {k: jnp.asarray(v) for k, v in batch.items()})
    launches = (kc.ce_fwd_launches, kc.ce_bwd_launches)
    got = make_eval_step(one_step["port"], classification=True, bins=BINS, aug=NO_AUG)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert (kc.ce_fwd_launches, kc.ce_bwd_launches) == launches
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_cli_trains_classification_two_steps_on_the_cpu(tmp_path, capsys):
    """``--loss classification --num-bins 16`` through the CLI: two steps,
    validation against GT, logs and a checkpoint that reloads strictly, and
    ``predict`` a disparity inside the bins' range [1/80, 1]."""
    rng = np.random.default_rng(0)
    K3 = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    for split, n in (("train", 6), ("val", 4)):
        depth = rng.uniform(1, 80, (n, H, W)) * (rng.uniform(size=(n, H, W)) < 0.2)
        write_split(tmp_path / "data" / split,
                    rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8),
                    np.stack([K3, K3]), [(0, n // 2), (n // 2, n)], depth.astype(np.float32))
    trainer = train_cli.main([
        str(tmp_path / "data"), "--network", "disp_res_18", "--loss", "classification",
        "--num-bins", str(K), "--max-depth", "80", "-b", "2", "--epoch-size", "2",
        "--epochs", "1", "--with-gt", "--use-pallas-losses", "--device", "cpu",
        "--checkpoints-dir", str(tmp_path / "ck"), "--name", "t"])
    assert trainer.step == 2 and trainer.classification and trainer.bins == BINS
    printed = capsys.readouterr().out
    assert "abs_rel=" in printed and "rmse=" in printed

    run = Path(trainer.cfg.save_path)
    events = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    iters = [e for e in events if e["event"] == "train_iter"]
    assert [e["step"] for e in iters] == [1, 2] and all(np.isfinite(e["loss"]) for e in iters)
    epoch = [e for e in events if e["event"] == "epoch"][0]
    assert all(np.isfinite(epoch[k]) for k in ("abs_rel", "rmse", "a1"))
    assert (run / BEST_NAME).is_file()
    fresh = DispResNet(DEPTH, head="classification", num_bins=K)
    fresh.load_state_dict(torch.load(run / CHECKPOINT_NAME, weights_only=False)["state_dict"],
                          strict=True)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    shutil.rmtree(tmp_path / "ck")  # checked: the disk is shared by the whole suite

    disp = trainer.predict(np.random.default_rng(1).uniform(size=(2, H, W, 3)))
    assert disp.shape == (2, H, W)
    assert ((disp >= 1 / 80) & (disp <= 1.0)).all()
