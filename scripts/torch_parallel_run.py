#!/usr/bin/env python3
"""One rank of a data-parallel (and spatial) run of the port, for
``chip_smoke.py``'s parallel and spatial phases. Start it under PyTorch's
launcher, one process a rank:

    python -m torch.distributed.run --nproc-per-node N scripts/torch_parallel_run.py \
        <out_dir> [--kinds berhu,classification,selfsup,berhu18,memory] [--steps K] \
        [--spatial-shards S] [--eval-batch] [-- <cli.train arguments>]

Each rank joins the process group (``parallel.mesh.init_from_env``: NCCL
when each rank has a card of its own, gloo where ranks share one; with
``--spatial-shards S`` the mesh is ``N / S`` data x S spatial ranks) and

1. checks a sum and a max over the ranks of a tensor on its card;
2. for each configuration of ``--kinds``, at 128x416 from seeded weights
   (DispResNet-50 BerHu, DispResNet-50 multi-scale classification with 64
   bins, DispNetS + PoseExpNet self-supervised, DispResNet-18 BerHu;
   ``memory``: DispResNet-50 BerHu at 384x1280, a global batch of 2), takes
   one train step on its
   rows of a seeded global batch of 4 (the augmentation drawn for the
   global batch), with every kernel count set to 0 just before it and read
   just after; rank 0 saves the loss, the gradients and the BatchNorm
   running statistics to ``<out_dir>/<kind>.pt``; then it times K more
   steps on the same batch, each by the host clock after a wait for the
   card, and the part of each spent in the all-reduces and in the halo
   exchanges (``parallel.Mesh.timed``: each collective waits for the card
   first); ``memory`` records the rank's ``torch.cuda.max_memory_allocated``
   over its build and steps;
3. with arguments after ``--``, trains through ``cli.train.main`` with them,
   its launches counted the same way; with ``--eval-batch`` it then runs the
   eval step with the trained model on a seeded validation batch of 4 (rank
   0 records the metrics; every rank a digest of its model's state) and
   saves the depth map of its rows of the batch to
   ``<out_dir>/eval_depth{r}.pt``;

and writes ``<out_dir>/rank{r}.json``.

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from supervised_dispnet_tpu_torch.ops.cuda import classification as kc  # noqa: E402
from supervised_dispnet_tpu_torch.ops.cuda import losses as kl  # noqa: E402
from supervised_dispnet_tpu_torch.ops.cuda import warp as kw  # noqa: E402
from supervised_dispnet_tpu_torch.parallel import mesh as parallel  # noqa: E402

SHAPE = (4, 128, 416)  # global B, H, W
MEMORY_SHAPE = (2, 384, 1280)  # full-resolution KITTI, what the spatial axis is for
COUNTERS = ((kl, "berhu_fwd_launches"), (kl, "berhu_fwd_given_c_launches"),
            (kl, "berhu_bwd_launches"), (kc, "ce_fwd_launches"), (kc, "ce_bwd_launches"),
            (kw, "warp_fwd_launches"), (kw, "warp_bwd_launches"),
            (kw, "warp_bwd_coords_launches"))


def zero_counts() -> None:
    for mod, attr in COUNTERS:
        setattr(mod, attr, 0)


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {attr: getattr(mod, attr) for mod, attr in COUNTERS}


def global_batch(kind: str, shape: tuple[int, int, int] | None = None) -> dict:
    """The seeded global batch of ``shape`` (default ``SHAPE``): uint8 frames
    (and, self-supervised, two reference frames), KITTI-like intrinsics,
    ~10% sparse depth."""
    B, H, W = shape or SHAPE
    rng = np.random.default_rng(7)
    K = np.array([[241.7, 0.0, W / 2], [0.0, 246.3, H / 2], [0.0, 0.0, 1.0]], np.float32)
    batch = {"tgt": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
             "intrinsics": np.tile(K, (B, 1, 1))}
    if kind == "selfsup":
        batch["ref_imgs"] = rng.integers(0, 256, (B, 2, H, W, 3), dtype=np.uint8)
    else:
        depth = rng.uniform(1.0, 80.0, (B, H, W)) * (rng.uniform(size=(B, H, W)) < 0.1)
        batch["depth"] = depth.astype(np.float16)
    return batch


def build_step(kind: str, device: torch.device, mesh, network: str = "disp_res_50"):
    """The configuration's nets on ``device`` and its train step on ``mesh``."""
    from supervised_dispnet_tpu_torch.losses.classification import DepthBins
    from supervised_dispnet_tpu_torch.models import PoseExpNet, get_disp_net
    from supervised_dispnet_tpu_torch.training.train_step import (
        make_selfsup_train_step, make_supervised_train_step)
    from supervised_dispnet_tpu_torch.training.trainer import TrainerConfig, build_optimizer
    from supervised_dispnet_tpu_torch.utils.device import set_fp32_math

    set_fp32_math()
    if kind == "selfsup":
        disp = get_disp_net("dispnet", seed=0, device=device)
        pose = PoseExpNet(generator=torch.Generator().manual_seed(1)).to(device)
        nets = {"disp": disp, "pose": pose}
        opt = build_optimizer(TrainerConfig(), [p for n in nets.values() for p in n.parameters()])
        step = make_selfsup_train_step(disp, pose, opt, mesh=mesh,
                                       photo_generator=torch.Generator().manual_seed(0))
    else:
        cls = kind == "classification"
        disp = get_disp_net(network, head="classification" if cls else "disp",
                            multiscale_classification=cls, seed=0, device=device)
        nets = {"disp": disp}
        opt = build_optimizer(TrainerConfig(), disp.parameters())
        step = make_supervised_train_step(disp, opt, "classification" if cls else "berhu",
                                          bins=DepthBins(), mesh=mesh)
    return nets, step


def collectives_agree(mesh, device: torch.device) -> bool:
    """A sum and a max over the ranks of a float32 tensor on the card."""
    t = torch.tensor([mesh.rank + 1.0, -float(mesh.rank)], device=device)
    total = mesh.all_reduce_(t.clone())
    top = mesh.all_reduce_(t.clone(), "max")
    n = mesh.size
    return (total.tolist() == [n * (n + 1) / 2, -n * (n - 1) / 2]
            and top.tolist() == [float(n), 0.0])


def one_step(out: Path, kind: str, device: torch.device, mesh, steps: int) -> dict:
    memory = kind == "memory"
    if memory:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    loss, network = {"berhu18": ("berhu", "disp_res_18"),
                     "memory": ("berhu", "disp_res_50")}.get(kind, (kind, "disp_res_50"))
    nets, step = build_step(loss, device, mesh, network)
    batch = parallel.shard_batch(global_batch(kind, MEMORY_SHAPE if memory else SHAPE),
                                 mesh, device)
    gen = torch.Generator(device=device).manual_seed(0)
    zero_counts()
    loss = float(step(batch, gen)["loss"])
    launches = read_counts()
    if mesh.is_main and not memory:
        torch.save({
            "loss": loss,
            "grads": {f"{tag}.{k}": p.grad.detach().cpu() for tag, net in nets.items()
                      for k, p in net.named_parameters() if p.grad is not None},
            "bn": {f"{tag}.{k}": v.detach().cpu() for tag, net in nets.items()
                   for k, v in net.state_dict().items() if "running_" in k}},
            out / f"{kind}.pt")
    times, collective, halo = [], [], []
    mesh.timed = True
    for _ in range(steps):
        mesh.collective_s = mesh.halo_s = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        collective.append(mesh.collective_s)
        halo.append(mesh.halo_s)
    mesh.timed = False
    record = {"loss": loss, "launches": launches, "step_ms": [t * 1e3 for t in times],
              "collective_ms": [c * 1e3 for c in collective],
              "halo_ms": [h * 1e3 for h in halo]}
    if memory:
        record["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    return record


def eval_batch(trainer, mesh, device: torch.device, out: Path) -> dict:
    """The eval step of the trained model on this rank's rows of a seeded
    validation batch of 4 (``global_batch``'s frames and depth), and the
    depth map of this rank's image rows, saved to ``out``."""
    from supervised_dispnet_tpu_torch.data.augment import normalize_images
    from supervised_dispnet_tpu_torch.parallel import spatial
    from supervised_dispnet_tpu_torch.training.train_step import (
        imgs_to_float, make_eval_step, output_depth)

    batch = global_batch("berhu")
    val = parallel.shard_batch({"img": batch["tgt"], "depth": batch["depth"]}, mesh, device)
    model, aug = trainer.model, trainer.aug
    rows = (spatial.shard_rows(batch["tgt"].shape[1], spatial.max_stride(model), mesh)
            if mesh.spatial > 1 else slice(None))
    with trainer.update.ema_params():
        metrics = make_eval_step(model, aug=aug, mesh=mesh)(val)
        img = normalize_images(imgs_to_float(val["img"]), aug.mean, aug.std)[:, rows]
        with torch.no_grad(), parallel.use_mesh(mesh):
            depth = output_depth(model(img))
    torch.save(depth.cpu(), out / f"eval_depth{mesh.rank}.pt")
    return {**{k: float(v) for k, v in metrics.items()}, "state_digest": state_digest(model)}


def state_digest(model: torch.nn.Module) -> str:
    """A digest of the model's parameters and buffers, bit for bit."""
    import hashlib

    h = hashlib.sha1()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def main() -> None:
    argv = sys.argv[1:]
    cli = []
    if "--" in argv:
        cut = argv.index("--")
        argv, cli = argv[:cut], argv[cut + 1:]
    p = argparse.ArgumentParser()
    p.add_argument("out")
    p.add_argument("--kinds", default="berhu,classification,selfsup")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--spatial-shards", type=int, default=1)
    p.add_argument("--eval-batch", action="store_true")
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    device, mesh = parallel.init_from_env("cuda", args.spatial_shards)
    try:
        record = {"rank": mesh.rank, "ranks": mesh.size, "spatial": mesh.spatial,
                  "backend": mesh.backend, "device": str(device),
                  "collectives": collectives_agree(mesh, device), "steps": {}}
        for kind in filter(None, args.kinds.split(",")):
            record["steps"][kind] = one_step(out, kind, device, mesh, args.steps)
        if cli:
            from supervised_dispnet_tpu_torch.cli import train as train_cli

            zero_counts()
            t0 = time.perf_counter()
            trainer = train_cli.main([*cli, "--device", str(device)])
            record["train"] = {"launches": read_counts(), "steps": trainer.update.micro_step,
                               "wall_s": time.perf_counter() - t0,
                               "run": str(trainer.cfg.save_path)}
            if args.eval_batch:
                record["train"]["eval"] = eval_batch(trainer, mesh, device, out)
        (out / f"rank{mesh.rank}.json").write_text(json.dumps(record))
        mesh.barrier()
    finally:
        parallel.shutdown()


if __name__ == "__main__":
    main()
