#!/usr/bin/env python3
"""Does the port's training converge? Two offline checks, on the card
unless ``--device cpu`` is given (the port's counterpart of
``benchmarks/convergence_check.py``):

- supervised (the default): depth is a deterministic function of the image
  (depth = 5 + 40 * the brightness of 8x8-pixel blocks), so a depth net can
  learn it; trains ``--network`` (disp_res_18) with BerHu, Adam 1e-4, no
  augmentation, and reports the val abs_rel before and after;
- ``--loss selfsup``: synthetic ego-motion video of textured planes
  (``data/synthetic.py``: a corridor with two floating quads, analytic
  depth, known poses); DispNetS + PoseExpNet train jointly through the
  port's self-supervised step (the photometric warp on the card's grouped
  kernels, Adam 2e-4, full augmentation), and it reports the median-scaled
  abs_rel against the analytic depth and the scale-aligned pose ATE / RE
  against the known motions, before and after. ``--stochastic-photo N``
  trains with the stochastic photometric term, to hold it against the full
  loss.

    python3 scripts/torch_convergence_check.py [--steps 300]
    python3 scripts/torch_convergence_check.py --loss selfsup --steps 600 \\
        [--stochastic-photo 2]

Prints progress, then one JSON line of results as its last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def synth_batch(rng: np.random.Generator, B: int, H: int, W: int):
    """(B, H, W, 3) images of 8x8 blocks in [0, 1] and their depth, 5 + 40
    times each block's brightness."""
    low = rng.uniform(0, 1, (B, H // 8, W // 8, 3)).astype(np.float32)
    img = np.repeat(np.repeat(low, 8, axis=1), 8, axis=2)
    return img, (5.0 + 40.0 * img.mean(axis=-1)).astype(np.float32)


def card(device) -> str | None:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def run_supervised(args, torch, device) -> dict:
    from supervised_dispnet_tpu_torch.data.augment import AugmentConfig
    from supervised_dispnet_tpu_torch.models import get_disp_net
    from supervised_dispnet_tpu_torch.training.train_step import (
        make_eval_step, make_supervised_train_step)
    from supervised_dispnet_tpu_torch.training.trainer import TrainerConfig, build_optimizer

    H, W, B = args.height, args.width, args.batch
    rng = np.random.default_rng(0)
    model = get_disp_net(args.network, seed=0, device=device)
    step = make_supervised_train_step(
        model, build_optimizer(TrainerConfig(lr=1e-4), model.parameters()), args.loss,
        aug=AugmentConfig(flip=False, scale_crop=False, color_jitter=False))
    evaluate = make_eval_step(model, aug=AugmentConfig())
    K = torch.tensor([[200.0, 0, W / 2], [0, 200.0, H / 2], [0, 0, 1]],
                     device=device).expand(B, 3, 3).contiguous()
    val_img, val_depth = synth_batch(np.random.default_rng(999), B, H, W)
    val = {"img": torch.from_numpy(val_img).to(device),
           "depth": torch.from_numpy(val_depth).to(device)}

    def val_abs_rel() -> float:
        return float(evaluate(val)["abs_rel"])

    initial = val_abs_rel()
    t0 = time.time()
    for i in range(args.steps):
        img, depth = synth_batch(rng, B, H, W)
        metrics = step({"tgt": torch.from_numpy(img).to(device), "intrinsics": K,
                        "depth": torch.from_numpy(depth).to(device)})
        if i % args.eval_every == 0:
            print(f"step {i}: loss {float(metrics['loss']):.4f} abs_rel "
                  f"{val_abs_rel():.4f}", flush=True)
    final = val_abs_rel()
    return {"metric": "synthetic_convergence_abs_rel", "initial": initial,
            "final": final, "converged": final < 0.5 * initial,
            "seconds": time.time() - t0}


def run_selfsup(args, torch, device) -> dict:
    from supervised_dispnet_tpu_torch.data.augment import (
        HALF_MEAN, HALF_STD, AugmentConfig, normalize_images)
    from supervised_dispnet_tpu_torch.data.synthetic import (
        PlaneSceneConfig, pose_errors, render_batch, scaled_abs_rel)
    from supervised_dispnet_tpu_torch.models import PoseExpNet, get_disp_net
    from supervised_dispnet_tpu_torch.training.train_step import make_selfsup_train_step
    from supervised_dispnet_tpu_torch.training.trainer import TrainerConfig, build_optimizer

    H, W, B = args.height, args.width, args.batch
    # a corridor (floor, ceiling, walls, back plane) and two floating quads:
    # one plane alone is homography-degenerate (any depth consistent with
    # the inter-frame homography reconstructs it), two or more tie the
    # motion, and with it the depth, down
    cfg = PlaneSceneConfig(height=H, width=W, focal=200.0 * W / 416, tilt=0.35,
                           center_depth=(5.0, 16.0), fg_planes=2, room=True, rot=0.04)
    rng = np.random.default_rng(0)
    disp_model = get_disp_net(args.network, seed=0, device=device)
    pose_model = PoseExpNet(nb_ref_imgs=cfg.nb_refs, output_exp=True,
                            generator=torch.Generator().manual_seed(1)).to(device)
    params = list(disp_model.parameters()) + list(pose_model.parameters())
    # full augmentation, as real training: the train batch carries no pose
    step = make_selfsup_train_step(
        disp_model, pose_model, build_optimizer(TrainerConfig(lr=2e-4), params),
        nb_ref_imgs=cfg.nb_refs, aug=AugmentConfig(), stochastic_photo=args.stochastic_photo,
        photo_generator=torch.Generator().manual_seed(0))
    generator = torch.Generator(device=device).manual_seed(0)

    # a pool of rendered snippets on the device as uint8, uploaded once
    n_pool = args.pool or max(8, min(24, args.steps // 4))
    print(f"rendering {n_pool} train batches of {B} snippets...", flush=True)
    t0 = time.time()
    pool = [render_batch(rng, B, cfg) for _ in range(n_pool)]

    def to_u8(x):
        return torch.from_numpy((x * 255).astype(np.uint8)).to(device)

    pool_dev = [{"tgt": to_u8(p["tgt"]), "ref_imgs": to_u8(p["ref_imgs"]),
                 "intrinsics": torch.from_numpy(p["intrinsics"]).to(device)} for p in pool]
    val = render_batch(np.random.default_rng(999), B, cfg)
    val_dev = {"tgt": to_u8(val["tgt"]), "ref_imgs": to_u8(val["ref_imgs"])}
    render_s = time.time() - t0

    @torch.no_grad()
    def predict(batch):
        def norm(u8):
            return normalize_images(u8.to(torch.float32) / 255.0, HALF_MEAN, HALF_STD)

        x = norm(batch["tgt"])
        disp_model.eval()
        pose_model.eval()
        disps = disp_model(x)
        _, pose = pose_model(x, [norm(batch["ref_imgs"][:, r]) for r in range(cfg.nb_refs)])
        d0 = disps[0] if isinstance(disps, list) else disps
        depth = 1.0 / d0[..., 0].clamp(min=1e-6)
        return depth.cpu().numpy(), pose.cpu().numpy()

    def evaluate() -> dict:
        depth, pose = predict(val_dev)
        ate, rot = pose_errors(pose, val["poses"])
        # in-sample depth error (pool batch 0): an optimisation failure
        # (train abs_rel flat) apart from a generalisation gap
        train_depth, _ = predict(pool_dev[0])
        return {"abs_rel": scaled_abs_rel(depth, val["depth"]),
                "train_abs_rel": scaled_abs_rel(train_depth, pool[0]["depth"]),
                "pose_ate_m": ate, "pose_rot_rad": rot}

    initial = evaluate()
    print(f"initial: {initial}", flush=True)
    curve = []
    t0 = time.time()
    for i in range(args.steps):
        metrics = step(pool_dev[i % n_pool], generator)
        if (i + 1) % args.eval_every == 0 or i == 0:
            m = evaluate()
            parts = {k: float(metrics[k]) for k in ("loss", "photo_loss", "smooth_loss")}
            curve.append({"step": i + 1, **parts, **m})
            print(f"step {i + 1}: {parts} {m}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.time() - t0
    final = evaluate()
    # depth is the primary signal (it needs the whole coupled system); the
    # pose must improve too, but tz dominates the synthetic motions, so the
    # scale-aligned ATE moves less than the rotation does
    return {"metric": "synthetic_selfsup_convergence", "initial": initial, "final": final,
            "stochastic_photo": args.stochastic_photo, "render_seconds": render_s,
            "seconds": seconds, "curve": curve,
            "converged": (final["abs_rel"] < 0.7 * initial["abs_rel"]
                          and final["pose_ate_m"] < 0.95 * initial["pose_ate_m"]
                          and final["pose_rot_rad"] < 0.8 * initial["pose_rot_rad"])}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loss", default="berhu", choices=["l1", "berhu", "scale_invariant",
                                                        "selfsup"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=0,
                    help="0: 32 supervised, 16 self-supervised")
    ap.add_argument("--network", default="",
                    help="default: disp_res_18 supervised, dispnet self-supervised")
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--pool", type=int, default=0,
                    help="selfsup: rendered train batches (0: steps / 4 within 8..24)")
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--stochastic-photo", type=int, default=1, metavar="N",
                    help="selfsup: the photometric term at every N-th pixel per axis "
                         "at a random phase a step (1: the full loss)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    selfsup = args.loss == "selfsup"
    args.batch = args.batch or (16 if selfsup else 32)
    args.network = args.network or ("dispnet" if selfsup else "disp_res_18")

    import torch

    from supervised_dispnet_tpu_torch.utils.device import resolve_device, set_fp32_math

    device = resolve_device(args.device)
    set_fp32_math()
    result = (run_selfsup if selfsup else run_supervised)(args, torch, device)
    result.update(loss=args.loss, network=args.network, steps=args.steps, batch=args.batch,
                  height=args.height, width=args.width, device=str(device), card=card(device))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
