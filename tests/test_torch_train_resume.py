"""The train CLI's options on the CPU, the port alone (their arithmetic
against the JAX package is ``test_torch_train_options.py``'s): an
interrupted run resumed with ``--resume`` equals an uninterrupted one bit
for bit, EMA, accumulation, hue and the generator included; a checkpoint
without EMA re-seeds the shadow; validation and ``predict`` use the shadow;
``--accum-steps 2`` over two half batches equals one full batch and its
schedule ticks once an update; ``--remat`` never takes the data root as its
value; ``--debug-nans`` raises before anything changes; ``--profile-steps``
writes a trace; ``--pretrained-encoder`` loads a torchvision ResNet's
weights and BN statistics; the step timers."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from supervised_dispnet_tpu_torch.cli import train as train_cli
from supervised_dispnet_tpu_torch.data.augment import AugmentConfig
from supervised_dispnet_tpu_torch.data.packed import write_split
from supervised_dispnet_tpu_torch.models import DispNetS, DispResNet
from supervised_dispnet_tpu_torch.models.resnet import ResNetEncoder
from supervised_dispnet_tpu_torch.training.train_step import make_supervised_train_step
from supervised_dispnet_tpu_torch.training.trainer import (
    Trainer, TrainerConfig, build_optimizer)
from supervised_dispnet_tpu_torch.utils.logging import TermLogger
from supervised_dispnet_tpu_torch.utils.profiling import StepTimer, steady_state_images_per_sec

B, H, W = 2, 32, 64
NO_AUG = AugmentConfig(flip=False, scale_crop=False, color_jitter=False)


def _split(root: Path, n_train: int = 10, n_val: int = 4) -> Path:
    rng = np.random.default_rng(0)
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    for split, n in (("train", n_train), ("val", n_val)):
        depth = rng.uniform(1, 80, (n, H, W)) * (rng.uniform(size=(n, H, W)) < 0.2)
        write_split(root / split, rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8),
                    np.stack([K, K]), [(0, n // 2), (n // 2, n)], depth.astype(np.float32))
    return root


def _batch(seed: int, n: int = B) -> dict[str, torch.Tensor]:
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1.0, 60.0, (n, H, W)) * (rng.uniform(size=(n, H, W)) < 0.5)
    return {"tgt": torch.from_numpy(rng.uniform(0, 1, (n, H, W, 3)).astype(np.float32)),
            "intrinsics": torch.eye(3).expand(n, 3, 3),
            "depth": torch.from_numpy(depth.astype(np.float32))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """DispResNet-18 (BN buffers), 3 micro-steps an epoch with k = 2 (a
    partial accumulation crosses the epoch's end), EMA, hue, ImageNet
    normalisation, an ImageNet encoder: 2 epochs straight ("a"), and 1
    epoch then ``--resume`` for the second ("b")."""
    tmp = tmp_path_factory.mktemp("resume")
    data = _split(tmp / "data")
    enc = ResNetEncoder(18)
    with torch.no_grad():
        for b in enc.buffers():
            if b.is_floating_point():
                b.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
    sd = {**enc.state_dict(), "fc.weight": torch.zeros(10, 512), "fc.bias": torch.zeros(10)}
    torch.save(sd, tmp / "resnet18.pth")
    argv = [str(data), "--network", "disp_res_18", "--loss", "berhu", "-b", str(B),
            "--epoch-size", "3", "--ema-decay", "0.9", "--accum-steps", "2", "--hue", "0.1",
            "--imagenet-normalization", "--pretrained-encoder", str(tmp / "resnet18.pth"),
            "--device", "cpu", "--checkpoints-dir", str(tmp / "ck")]
    a = train_cli.main([*argv, "--epochs", "2", "--name", "a", "--profile-steps", "9"])
    train_cli.main([*argv, "--epochs", "1", "--name", "b"])
    b = train_cli.main([*argv, "--epochs", "2", "--name", "b", "--resume"])
    yield {"a": a, "b": b, "encoder": sd}
    shutil.rmtree(tmp)  # ~1 GB of checkpoints


def test_resumed_run_equals_an_uninterrupted_one_bit_for_bit(runs):
    a, b = runs["a"], runs["b"]
    assert a.update.micro_step == b.update.micro_step == 6 and a.step == b.step == 3
    for (k, va), (_, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(va, vb), k
    for ea, eb in zip(a.update.ema, b.update.ema):
        assert torch.equal(ea, eb)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a.update.state_dict()["acc"] is None and b.update.state_dict()["acc"] is None


def test_resume_continues_the_step_logs_and_csv(runs):
    """The resumed epoch starts where epoch 0 left off: its train steps are
    4..6 and the CSV gains a row rather than starting over; the checkpoint
    it leaves restores to its end state."""
    b = runs["b"]
    run = Path(b.cfg.save_path)
    events = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert [e["step"] for e in events if e["event"] == "train_iter"] == [1, 2, 3, 4, 5, 6]
    assert [e["epoch"] for e in events if e["event"] == "epoch"] == [0, 1]
    assert len((run / "progress_log_summary.csv").read_text().splitlines()) == 3
    fresh = Trainer(b.cfg, DispResNet(18), device="cpu")
    assert fresh.restore(run)["epoch"] == 1 and fresh.update.micro_step == 6
    for x, y in zip(fresh.update.ema, b.update.ema):
        assert torch.equal(x, y)


def test_profile_steps_writes_a_trace_clamped_to_the_epoch(runs):
    trace = Path(runs["a"].cfg.save_path) / "profile" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("convolution" in e.get("name", "") for e in events)


def test_pretrained_encoder_holds_the_torchvision_weights_and_bn_statistics(runs, tmp_path):
    model = DispResNet(18)
    torch.save(runs["encoder"], tmp_path / "full.pth")
    train_cli.load_pretrained_encoder(model, tmp_path / "full.pth", "disp_res_18")
    for k, v in model.encoder.state_dict().items():
        assert torch.equal(v, runs["encoder"][k]), k
    torch.save({k: v for k, v in runs["encoder"].items() if not k.startswith("layer4")},
               tmp_path / "cut.pth")
    with pytest.raises(KeyError, match="layer4"):
        train_cli.load_pretrained_encoder(DispResNet(18), tmp_path / "cut.pth", "disp_res_18")


def _trainer(**kw) -> Trainer:
    return Trainer(TrainerConfig(**kw), DispNetS(generator=torch.Generator().manual_seed(2)),
                   device="cpu")


def test_a_checkpoint_without_ema_reseeds_the_shadow(tmp_path):
    plain = _trainer()
    with torch.no_grad():
        for p in plain.model.parameters():
            p.add_(0.5)
    plain.save_checkpoint(tmp_path, 0, True)
    ema = _trainer(ema_decay=0.99)
    assert ema.restore(tmp_path) == {"epoch": 0, "best": float("inf")}
    for e, p in zip(ema.update.ema, plain.model.parameters()):
        assert torch.equal(e, p.detach())


def test_validation_and_predict_use_the_shadow(tmp_path):
    """With EMA, ``validate`` and ``predict`` give what a model holding the
    shadow (and the live BN buffers) gives; the live weights stay."""
    t = _trainer(ema_decay=0.99, data=str(_split(tmp_path)), batch_size=B)
    with torch.no_grad():
        for e in t.update.ema:
            e.mul_(0.5)
    shadow = _trainer(data=t.cfg.data, batch_size=B)
    shadow.model.load_state_dict(dict(zip((n for n, _ in t.model.named_parameters()),
                                          t.update.ema)), strict=True)
    imgs = np.random.default_rng(3).uniform(size=(1, H, W, 3)).astype(np.float32)
    np.testing.assert_array_equal(t.predict(imgs), shadow.predict(imgs))
    metrics = [tr.validate(tr.make_loaders()[1], TermLogger(1, 1, 2)) for tr in (t, shadow)]
    assert metrics[0] == metrics[1]
    assert not torch.equal(next(t.model.parameters()), t.update.ema[0])


def test_two_accumulated_half_batches_equal_one_full_batch():
    """As ``tests/test_accum.py`` holds optax.MultiSteps: no BN, no
    augmentation; the mean of the half-batch gradients equals the full
    batch's to rounding, which Adam's first update turns into at most 2 lr
    where a gradient is ~0."""
    lr, full = 1e-3, _batch(4, n=4)
    params = []
    for k, batches in ((1, [full]), (2, [{n: v[:2] for n, v in full.items()},
                                          {n: v[2:] for n, v in full.items()}])):
        model = DispNetS(generator=torch.Generator().manual_seed(5))
        step = make_supervised_train_step(
            model, build_optimizer(TrainerConfig(lr=lr), model.parameters()), "l1",
            aug=NO_AUG, accum_steps=k)
        for batch in batches:
            step(batch)
        assert step.update.updates == 1
        params.append([p.detach() for p in model.parameters()])
    for a, b in zip(*params):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=2 * lr)


def test_the_schedule_ticks_once_an_update():
    t = _trainer(lr=1.0, lr_schedule="step", lr_decay_steps=1, accum_steps=2)
    t.aug = NO_AUG
    seen = []
    for i in range(4):
        t.train_step(_batch(i))
        seen.append(t.optimizer.param_groups[0]["lr"])
    assert seen == [1.0, 1.0, 0.5, 0.5] and t.step == 2 and t.update.micro_step == 4


@pytest.mark.parametrize("argv,data,remat", [
    (["--remat", "DATA"], "DATA", "full"), (["DATA", "--remat"], "DATA", "full"),
    (["DATA", "--remat", "conv"], "DATA", "conv"), (["--remat", "conv", "DATA"], "DATA", "conv"),
    (["--remat=full", "DATA"], "DATA", "full"), (["DATA"], "DATA", None)])
def test_remat_never_takes_the_data_root(argv, data, remat):
    args = train_cli.parse_args(argv)
    assert (args.data, args.remat) == (data, remat)


def test_debug_nans_raises_naming_the_step_before_any_update():
    t = _trainer(debug_nans=True, ema_decay=0.9)
    t.aug = NO_AUG
    t.train_step(_batch(0))
    before = [p.detach().clone() for p in t.model.parameters()]
    ema = [e.clone() for e in t.update.ema]
    bad = _batch(1)
    bad["tgt"][0, 3, 5, 1] = float("nan")
    with pytest.raises(FloatingPointError, match="loss.*train step 1"):
        t.train_step(bad)
    assert all(torch.equal(p, q) for p, q in zip(t.model.parameters(), before))
    assert all(torch.equal(e, f) for e, f in zip(t.update.ema, ema))


def test_steady_state_images_per_sec_and_step_timer():
    calls = []
    ips = steady_state_images_per_sec(lambda: calls.append(1), batch_size=8,
                                      device=torch.device("cpu"), iters=5, warmup=2)
    assert len(calls) == 7 and ips > 0
    timer = StepTimer()
    for _ in range(3):
        timer.mark_data()
        timer.mark_step()
    avg = timer.averages()
    assert timer.count == 3 and 0 <= avg["data_time"] <= avg["batch_time"]
