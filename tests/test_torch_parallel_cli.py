"""The training CLI on two ranks on the CPU (``--device cpu``, gloo), as
``torch.distributed.run`` starts it: two processes of ``python -m
supervised_dispnet_tpu_torch.cli.train`` with the launcher's environment
(RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT on
a localhost port bound to 0 first). DispResNet-18 BerHu at 64x96, a global
batch of 4, 2 steps, with ``--loader threads`` and ``--loader device``:
rank 0 alone writes the run (one run directory, one checkpoint); the
checkpoint equals a one-process run's: the logged losses rtol 1e-5, each
decoder and head tensor within 1e-3 of how far the steps moved it
(measured 1.6e-4), the encoder as a whole within 1e-2 (measured 6.5e-4:
Adam's first updates, about lr * sign(g), follow the sign of an entry that
rounding decides; ROADMAP C4), BatchNorm's running statistics rel-L2 1e-4;
``--resume`` continues on 2 ranks to the second epoch. The same run with
``--spatial-shards 2`` (``parallel/spatial.py``: each rank half the image
rows of the whole batch) equals the one-process run as closely; its
checkpoint loads into a one-process model, and its run is deleted."""

import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from supervised_dispnet_tpu_torch.cli import train as train_cli
from supervised_dispnet_tpu_torch.data.packed import write_split
from supervised_dispnet_tpu_torch.models import get_disp_net
from supervised_dispnet_tpu_torch.training.trainer import CHECKPOINT_NAME
from tests.torch_threads import TORCH_THREADS, cap_torch_threads

cap_torch_threads()

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 96
TIMEOUT_S = 120.0


def _packed(root: Path) -> None:
    rng = np.random.default_rng(0)
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    for split, n in (("train", 8), ("val", 4)):
        images = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
        depth = rng.uniform(1, 80, (n, H, W)) * (rng.uniform(size=(n, H, W)) < 0.2)
        write_split(root / split, images, np.stack([K, K]), [(0, n // 2), (n // 2, n)],
                    depth.astype(np.float32))


def _argv(data: Path, ck: Path, *extra: str) -> list[str]:
    return [str(data), "--network", "disp_res_18", "--loss", "berhu", "-b", "4",
            "--epoch-size", "2", "--device", "cpu", "--checkpoints-dir", str(ck),
            "--name", "t", "-j", "1", *extra]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: list[str], tmp: Path, world: int = 2) -> list[str]:
    """``cli.train`` on ``world`` ranks, as the launcher starts them; each
    rank's output. A deadline kills both and fails the test."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = {**os.environ, "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(world),
               "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": str(TORCH_THREADS)}
        log = open(tmp / f"cli_rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "supervised_dispnet_tpu_torch.cli.train", *argv],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    out = [(tmp / f"cli_rank{r}.log").read_text() for r in range(world)]
    codes = [p.returncode for p, _ in procs]
    assert codes == [0] * world, f"ranks exited {codes}:\n" + "\n".join(o[-3000:] for o in out)
    return out


def _gap(got: dict, ref: dict, init: dict, names: list[str]) -> float:
    """||got - ref|| / ||ref - init|| over ``names`` at once."""
    d = torch.cat([(got[k] - ref[k]).flatten() for k in names])
    u = torch.cat([(ref[k] - init[k].detach()).flatten() for k in names])
    return float(d.norm() / u.norm())


def _checkpoint(ck: Path) -> tuple[Path, dict]:
    runs = [d for d in (ck / "t").iterdir() if d.is_dir()]
    assert len(runs) == 1, runs
    return runs[0], torch.load(runs[0] / CHECKPOINT_NAME, map_location="cpu",
                               weights_only=True)


@pytest.fixture(scope="module")
def data(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("data")
    _packed(root)
    return root


@pytest.fixture(scope="module")
def first_epoch(data, tmp_path_factory):
    """One epoch on two ranks with ``--loader threads``, launched once: the
    run that the threads case checks and the resume test continues (each
    from its own copy); removed after the module."""
    tmp = tmp_path_factory.mktemp("first_epoch")
    out = launch(_argv(data, tmp / "two", "--epochs", "1", "--loader", "threads"), tmp)
    yield tmp / "two", out
    shutil.rmtree(tmp / "two")


@pytest.fixture(scope="module")
def one_process_epoch(data, tmp_path_factory):
    """The same epoch in one process with ``--loader threads``: its trainer
    and logged losses."""
    one = train_cli.main(_argv(data, tmp_path_factory.mktemp("one"), "--epochs", "1",
                               "--loader", "threads"))
    return one, _losses(Path(one.cfg.save_path))


def _losses(run: Path) -> list[float]:
    return [json.loads(x)["loss"] for x in (run / "metrics.jsonl").read_text().splitlines()
            if '"train_iter"' in x]


def hold_like_one_process(two: dict, losses: list[float], one, one_losses) -> None:
    """A two-rank run's checkpoint and logged losses against the one-process
    run's (module docstring's tolerances)."""
    assert one.step == two["step"] == 2
    init = dict(get_disp_net("disp_res_18", seed=0, device="cpu").named_parameters())
    ref = one.model.state_dict()
    enc = [k for k in init if k.startswith("encoder.")]
    for k in init:
        if k not in enc:
            assert _gap(two["state_dict"], ref, init, [k]) <= 1e-3, k
    assert _gap(two["state_dict"], ref, init, enc) <= 1e-2
    for k, v in ref.items():
        if "running_" in k:
            assert float((two["state_dict"][k] - v).norm()) <= 1e-4 * float(v.norm()), k
    np.testing.assert_allclose(losses, one_losses, rtol=1e-5)


@pytest.mark.parametrize("loader", ["threads", "device"])
def test_cli_on_two_ranks_writes_one_run_equal_to_one_process(data, tmp_path, loader,
                                                              request):
    if loader == "threads":
        first, out = request.getfixturevalue("first_epoch")
        shutil.copytree(first, tmp_path / "two")
    else:
        out = launch(_argv(data, tmp_path / "two", "--epochs", "1", "--loader", loader),
                     tmp_path)
    assert "=> data-parallel: 2 rank(s), backend gloo" in out[0]
    assert "abs_rel=" in out[0] and "=> saving to" in out[0]
    assert "=> saving to" not in out[1] and "abs_rel=" not in out[1]
    run, two = _checkpoint(tmp_path / "two")
    names = sorted(p.name for p in run.iterdir())
    # rank 0's tensorboard events file, where tensorboardX imports
    events_files = [n for n in names if n.startswith("events.out.tfevents")]
    assert len(events_files) <= 1
    assert [n for n in names if n not in events_files] == sorted([
        CHECKPOINT_NAME, "dispnet_model_best.pth.tar", "metrics.jsonl",
        "progress_log_full.csv", "progress_log_summary.csv", "trainer_meta.json"])
    events = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert [e["step"] for e in events if e["event"] == "train_iter"] == [1, 2]

    if loader == "threads":
        one, want = request.getfixturevalue("one_process_epoch")
    else:
        one = train_cli.main(_argv(data, tmp_path / "one", "--epochs", "1", "--loader", loader))
        want = _losses(Path(one.cfg.save_path))
    hold_like_one_process(two, _losses(run), one, want)


def test_cli_with_spatial_shards_on_two_ranks_equals_one_process(data, tmp_path,
                                                                 one_process_epoch):
    out = launch(_argv(data, tmp_path / "two", "--epochs", "1", "--spatial-shards", "2"),
                 tmp_path)
    assert "=> data-parallel: 2 rank(s), 1 data x 2 spatial, backend gloo" in out[0]
    assert "abs_rel=" in out[0] and "=> saving to" in out[0]
    assert "=> saving to" not in out[1]
    run, two = _checkpoint(tmp_path / "two")
    get_disp_net("disp_res_18", device="cpu").load_state_dict(two["state_dict"], strict=True)
    hold_like_one_process(two, _losses(run), *one_process_epoch)
    shutil.rmtree(tmp_path / "two")


def test_resume_continues_on_two_ranks(data, tmp_path, first_epoch):
    shutil.copytree(first_epoch[0], tmp_path, dirs_exist_ok=True)
    out = launch(_argv(data, tmp_path, "--epochs", "2", "--resume"), tmp_path)
    assert "=> resumed after epoch 0 (train step 2" in out[0]
    assert "resumed" not in out[1]
    run, blob = _checkpoint(tmp_path)
    assert (blob["epoch"], blob["step"], blob["micro_step"]) == (1, 4, 4)
    steps = [json.loads(x)["step"] for x in (run / "metrics.jsonl").read_text().splitlines()
             if '"train_iter"' in x]
    assert steps == [1, 2, 3, 4]
