"""The ranks of the port's data-parallel tests, and their spawner.

``spawn(cases, tmp, world)`` starts ``world`` processes of

    python -m tests.torch_ranks <cases.pt> <store> <rank> <world> <out.pt>

which meet over gloo through a ``FileStore`` in ``tmp`` (no TCP port, so
test workers running side by side do not collide), run every case of
``cases`` under the mesh (``run_case``) and save their results. A spawn has a
deadline and kills its children when it passes: a hang fails the test, it
does not stall the suite. A rank imports only torch and the port; it
reports the modules it loaded, so a test can hold it to that. Rank 0
returns the state after a case; every rank a digest of it, so that a test
can hold the ranks to the same state bit for bit.

``run_case(case, mesh)`` also runs in the test's own process on a mesh of one
rank: the port's one-process reference.
"""

from __future__ import annotations

import hashlib
import subprocess
import sys
import time
from pathlib import Path

import torch

from supervised_dispnet_tpu_torch.data.augment import AugmentConfig
from supervised_dispnet_tpu_torch.losses.classification import DepthBins
from supervised_dispnet_tpu_torch.models import DispNetS, DispResNet, PoseExpNet
from supervised_dispnet_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from supervised_dispnet_tpu_torch.training.train_step import (
    make_eval_step, make_selfsup_eval_step, make_selfsup_train_step,
    make_supervised_train_step)
from supervised_dispnet_tpu_torch.training.trainer import TrainerConfig, build_optimizer
from tests.torch_threads import cap_torch_threads

REPO = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 150.0


def _draws(draws: dict | None) -> dict | None:
    return None if draws is None else {k: torch.as_tensor(v) for k, v in draws.items()}


def _models(case: dict) -> dict[str, torch.nn.Module]:
    if case["kind"] in ("supervised", "eval"):
        m = case["model"]
        model = DispResNet(m["depth"], head=m.get("head", "disp"),
                           num_bins=m.get("num_bins", 64),
                           multiscale_classification=m.get("multiscale", False))
        model.load_state_dict(case["state_dict"], strict=True)
        return {"disp": model}
    exp = case.get("pose_exp", case["weights"]["mask_weight"] > 0)
    disp, pose = DispNetS(), PoseExpNet(nb_ref_imgs=case["refs"], output_exp=exp)
    disp.load_state_dict(case["disp_sd"], strict=True)
    pose.load_state_dict(case["pose_sd"], strict=True)
    return {"disp": disp, "pose": pose}


def _digest(state: dict) -> str:
    h = hashlib.sha1()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_case(case: dict, mesh: Mesh) -> dict:
    """One case on ``mesh``: its train steps (each given the global batch,
    of which the step takes this rank's rows) or its eval step. Returns the
    metrics of each step, a digest of the models' state after them and, on
    rank 0, the state itself, the EMA shadow, and (``case["grads"]``) the
    last step's gradients; and any error raised."""
    torch.manual_seed(0)
    nets = _models(case)
    aug = AugmentConfig(**case.get("aug", {}))
    gen = torch.Generator().manual_seed(case.get("seed", 0))
    out: dict = {"metrics": []}
    if case["kind"] == "eval":
        step = make_eval_step(nets["disp"], aug=aug, mesh=mesh)
    elif case["kind"] == "selfsup_eval":
        step = make_selfsup_eval_step(nets["disp"], nets["pose"], nb_ref_imgs=case["refs"],
                                      with_exp=case["weights"]["mask_weight"] > 0, aug=aug,
                                      mesh=mesh)
    else:
        params = [p for net in nets.values() for p in net.parameters()]
        opt = (torch.optim.Adam(params, lr=case["lr"], eps=case["eps"]) if "eps" in case
               else build_optimizer(TrainerConfig(lr=case["lr"]), params))
        opts = case.get("opts", {})
        if case["kind"] == "supervised":
            m = case["model"]
            bins = DepthBins(num_bins=m["num_bins"]) if m.get("head") == "classification" \
                else None
            step = make_supervised_train_step(nets["disp"], opt, case["loss"], bins=bins,
                                              aug=aug, mesh=mesh, **opts)
        else:
            step = make_selfsup_train_step(
                nets["disp"], nets["pose"], opt, nb_ref_imgs=case["refs"], aug=aug,
                photo_generator=torch.Generator().manual_seed(case.get("seed", 0)),
                mesh=mesh, **case["weights"], **opts)
    try:
        for i, batch in enumerate(case["batches"]):
            local = shard_batch(batch, mesh)
            if case["kind"] in ("eval", "selfsup_eval"):
                metrics = step(local)
            else:
                kw = {"generator": gen, "draws": _draws(case["draws"][i])}
                if case.get("phases"):
                    kw["photo_phases"] = case["phases"][i]
                metrics = step(local, **kw)
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
    except Exception as e:  # noqa: BLE001 - reported to the test, which decides
        out["raised"] = f"{type(e).__name__}: {e}"
    state = {f"{tag}.{k}": v.detach().clone() for tag, net in nets.items()
             for k, v in net.state_dict().items()}
    out["digest"] = _digest(state)
    if not mesh.is_main:
        return out
    out["state"] = state
    if case.get("grads"):
        out["grads"] = {f"{tag}.{k}": p.grad.detach().clone() for tag, net in nets.items()
                        for k, p in net.named_parameters() if p.grad is not None}
    if case["kind"] in ("supervised", "selfsup") and step.update.ema is not None:
        out["ema"] = dict(zip(step.update.names, (e.clone() for e in step.update.ema)))
    return out


def spawn(cases: dict, tmp: Path, world: int = 2,
          timeout: float = SPAWN_TIMEOUT_S) -> list[dict]:
    """Run ``cases`` on ``world`` ranks; returns each rank's results (rank
    order), each with ``"modules"``, the modules the rank had loaded."""
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(cases, tmp / "cases.pt")
    store = tmp / "store"
    store.unlink(missing_ok=True)
    procs, logs = [], []
    for r in range(world):
        log = open(tmp / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_ranks", str(tmp / "cases.pt"), str(store),
             str(r), str(world), str(tmp / f"rank{r}.pt")],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the {world} ranks did not finish in {timeout} s:\n"
                             + _tails(tmp, world)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"ranks exited with {codes}:\n" + _tails(tmp, world))
    results = []
    for r in range(world):
        results.append(torch.load(tmp / f"rank{r}.pt", weights_only=False))
        (tmp / f"rank{r}.pt").unlink()
    (tmp / "cases.pt").unlink()
    return results


def _tails(tmp: Path, world: int) -> str:
    return "\n".join(f"--- rank {r}:\n" + (tmp / f"rank{r}.log").read_text()[-3000:]
                     for r in range(world))


def main(argv: list[str]) -> None:
    import torch.distributed as dist

    cases_path, store, rank, world, out_path = argv
    rank, world = int(rank), int(world)
    cap_torch_threads()
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh()
        cases = torch.load(cases_path, weights_only=False)
        results = {name: run_case(case, mesh) for name, case in cases.items()}
        results["modules"] = sorted(sys.modules)
        torch.save(results, out_path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
