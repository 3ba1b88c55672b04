"""The ranks of the port's data-parallel and spatial tests, and their
spawner.

``start(cases, tmp, world)`` starts ``world`` processes of

    python -m tests.torch_ranks <cases.pt> <store> <rank> <world> <out.pt> <late.pt>

which meet over gloo through a ``FileStore`` in ``tmp`` (no TCP port, so
test workers running side by side do not collide), run every case of
``cases`` under the mesh (``run_case``; ``make_mesh(case["spatial"])``,
1 by default) and save their results. It returns the ranks in flight
(``Ranks``): the test computes its JAX references meanwhile, then hands
the ranks the cases that need them (``Ranks.late``, maybe none; the ranks
wait for them) and collects every result (``Ranks.wait``). A spawn has a
deadline and kills its children when it passes: a hang fails the test, it
does not stall the suite. A rank imports only torch and the port; it
reports the modules it loaded, so a test can hold it to that. Rank 0
returns the state after a case; every rank a digest of it, so that a test
can hold the ranks to the same state bit for bit.

``run_case(case, mesh)`` also runs in the test's own process on a mesh of one
rank: the port's one-process reference. An ``ops`` case runs single ops of
the spatial axis (``SpatialOp``) over this rank's rows of their inputs.
"""

from __future__ import annotations

import hashlib
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch import nn

from supervised_dispnet_tpu_torch.data.augment import AugmentConfig
from supervised_dispnet_tpu_torch.losses.classification import DepthBins
from supervised_dispnet_tpu_torch.models import DispNetS, DispResNet, PoseExpNet, get_disp_net
from supervised_dispnet_tpu_torch.models.common import crop_like, fused_upsample_conv
from supervised_dispnet_tpu_torch.models.fcrn import unpool_conv
from supervised_dispnet_tpu_torch.ops.resize import interpolate_bilinear
from supervised_dispnet_tpu_torch.parallel import spatial
from supervised_dispnet_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch, use_mesh
from supervised_dispnet_tpu_torch.training.train_step import (
    make_eval_step, make_selfsup_eval_step, make_selfsup_train_step,
    make_supervised_train_step)
from supervised_dispnet_tpu_torch.training.trainer import TrainerConfig, build_optimizer

REPO = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 600.0  # the ranks also wait for the test's JAX references


def _draws(draws: dict | None) -> dict | None:
    return None if draws is None else {k: torch.as_tensor(v) for k, v in draws.items()}


class SpatialOp(nn.Module):
    """One op of the spatial axis as the models call it, over NCHW inputs:
    ``module`` (a conv or a block), ``max_pool`` (the ResNet stem's
    3x3/2), ``unpool`` (FCRN's transposed conv, ``conv``'s weights),
    ``bilinear`` (upsample by ``factor``), ``fused`` (the fused decoder
    stage of ``conv``: inputs h and, where given, the skip) or ``crop``
    (``crop_like`` to one column fewer)."""

    def __init__(self, kind: str, conv: nn.Module | None = None, factor: int = 2):
        super().__init__()
        self.kind, self.conv, self.factor = kind, conv, factor

    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        x = xs[0]
        if self.kind == "module":
            return self.conv(x)
        if self.kind == "max_pool":
            return spatial.max_pool2d(x, 3, 2, 1)
        if self.kind == "unpool":
            return unpool_conv(x, self.conv)
        if self.kind == "bilinear":
            f = self.factor
            return interpolate_bilinear(x, x.shape[2] * f, x.shape[3] * f + 1)
        if self.kind == "fused":
            return fused_upsample_conv(self.conv, x, xs[1] if len(xs) > 1 else None,
                                       (2 * x.shape[2], 2 * x.shape[3]), 0)
        if self.kind == "crop":
            return crop_like(x, x[..., :-1])
        raise ValueError(self.kind)


def run_ops(case: dict, mesh: Mesh) -> dict:
    """Each op of ``case["ops"]`` over this rank's rows: its inputs'
    rows ``[a u, b u)`` for the rank's deep rows [a, b) of ``deep`` and an
    input's ``u`` rows a deep row, forward and backward against this rank's
    rows of the upstream gradient. Returns each op's output rows, its
    inputs' gradient rows and its parameters' gradients (this rank's
    share)."""
    out = {}
    for name, spec in case["ops"].items():
        a, b = spatial.deep_split(spec["deep"], mesh.spatial)[mesh.spatial_rank]
        xs = [x[:, :, a * u:b * u].clone().requires_grad_(True) for x, u in spec["inputs"]]
        op, u = spec["op"], spec["out_unit"]
        op.zero_grad(set_to_none=True)
        with use_mesh(mesh):
            y = op(*xs)
            (y * spec["grad"][:, :, a * u:b * u]).sum().backward()
        out[name] = {"y": y.detach(), "x_grads": [x.grad for x in xs],
                     "p_grads": {n: p.grad for n, p in op.named_parameters()}}
    return out


def _models(case: dict) -> dict[str, torch.nn.Module]:
    if case["kind"] in ("supervised", "eval"):
        m = case["model"]
        if "network" in m:
            model = get_disp_net(m["network"], head=m.get("head", "disp"),
                                 num_bins=m.get("num_bins", 64),
                                 multiscale_classification=m.get("multiscale", False),
                                 fused_upsample=m.get("fused", False),
                                 remat=m.get("remat", False), bf16=m.get("bf16", False),
                                 device="cpu")
        else:
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
    if case["kind"] == "ops":
        return run_ops(case, mesh)
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


class Ranks:
    """``world`` ranks running ``cases`` (``start``), which then wait for
    the cases that ``late()`` hands them."""

    def __init__(self, cases: dict, tmp: Path, world: int, timeout: float):
        tmp.mkdir(parents=True, exist_ok=True)
        torch.save(cases, tmp / "cases.pt")
        store = tmp / "store"
        store.unlink(missing_ok=True)
        self.tmp, self.world, self.timeout = tmp, world, timeout
        self.late_path = tmp / "late.pt"
        self.late_path.unlink(missing_ok=True)
        self.procs, self.logs = [], []
        for r in range(world):
            log = open(tmp / f"rank{r}.log", "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_ranks", str(tmp / "cases.pt"), str(store),
                 str(r), str(world), str(tmp / f"rank{r}.pt"), str(self.late_path)],
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
        self.deadline = time.monotonic() + timeout

    def late(self, cases: dict) -> None:
        """Hand the waiting ranks their last cases."""
        part = self.late_path.with_suffix(".part")
        torch.save(cases, part)
        part.replace(self.late_path)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()

    def wait(self) -> list[dict]:
        """Each rank's results (rank order), each with ``"modules"``, the
        modules the rank had loaded; a deadline kills the ranks."""
        try:
            for p in self.procs:
                p.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"the {self.world} ranks did not finish in {self.timeout} s:\n"
                                 + _tails(self.tmp, self.world)) from None
        finally:
            self.kill()
        codes = [p.returncode for p in self.procs]
        if any(codes):
            raise AssertionError(f"ranks exited with {codes}:\n" + _tails(self.tmp, self.world))
        results = []
        for r in range(self.world):
            results.append(torch.load(self.tmp / f"rank{r}.pt", weights_only=False))
            (self.tmp / f"rank{r}.pt").unlink()
        (self.tmp / "cases.pt").unlink()
        self.late_path.unlink(missing_ok=True)
        return results


def start(cases: dict, tmp: Path, world: int = 2, timeout: float = SPAWN_TIMEOUT_S) -> Ranks:
    """``cases`` on ``world`` ranks in flight, which then wait for
    ``Ranks.late``'s cases."""
    return Ranks(cases, tmp, world, timeout)


def _tails(tmp: Path, world: int) -> str:
    return "\n".join(f"--- rank {r}:\n" + (tmp / f"rank{r}.log").read_text()[-3000:]
                     for r in range(world))


def main(argv: list[str]) -> None:
    import torch.distributed as dist

    cases_path, store, rank, world, out_path, late = argv
    rank, world = int(rank), int(world)
    # one intra-op thread a rank: a test runs up to 6 ranks beside the
    # suite's other workers, and its small ops gain little from a second
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    meshes: dict[int, Mesh] = {}

    def run(case: dict) -> dict:
        # every rank makes the meshes (and their groups) in case order
        s = case.get("spatial", 1)
        if s not in meshes:
            meshes[s] = make_mesh(s)
        return run_case(case, meshes[s])

    try:
        cases = torch.load(cases_path, weights_only=False)
        results = {name: run(case) for name, case in cases.items()}
        while not Path(late).exists():
            time.sleep(0.05)
        for name, case in torch.load(late, weights_only=False).items():
            results[name] = run(case)
        results["modules"] = sorted(sys.modules)
        torch.save(results, out_path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
