"""Odometry pose evaluation CLI of the port, with the JAX CLI's flag
spellings (``supervised_dispnet_tpu/cli/test_pose.py``; reference
``test_pose.py``): PoseExpNet's snippet ATE / RE on KITTI odometry
sequences.

  python -m supervised_dispnet_tpu_torch.cli.test_pose \\
      --pretrained-posenet exp_pose_model_best.pth.tar \\
      --dataset-dir /data/kitti_odometry --sequences 09 10

Expects ``<dataset-dir>/sequences/<seq>/image_2/*.png`` and
``<dataset-dir>/poses/<seq>.txt``. Each frame is decoded once and
area-resized to the network input as uint8; batches of ``--batch-size``
snippets go to the card as uint8 and are normalised there, in full fp32.
``--output-dir`` saves the predictions, as the reference's CLI does. Runs
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="KITTI odometry pose evaluation, snippet ATE/RE (PyTorch port, CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--pretrained-posenet", required=True,
                   help="exp_pose .pth.tar (the port's Trainer or the reference)")
    p.add_argument("--dataset-dir", required=True)
    p.add_argument("--sequences", nargs="+", default=["09"])
    p.add_argument("--sequence-length", type=int, default=3)
    p.add_argument("--img-height", type=int, default=128)
    p.add_argument("--img-width", type=int, default=416)
    p.add_argument("--rotation-mode", default="euler", choices=["euler", "quat"])
    p.add_argument("--imagenet-normalization", action="store_true")
    p.add_argument("--batch-size", type=int, default=32, help="snippets per forward")
    p.add_argument("--output-dir", default=None,
                   help="save the snippets' predicted poses (predictions.npy, (N, R, "
                        "3, 4), as the reference saves them) and the network's pose "
                        "vectors (pose_vectors.npy, (N, R - 1, 6))")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs on the CPU")
    return p


def pose_vec_to_snippet(poses_vec: np.ndarray, rotation_mode: str) -> np.ndarray:
    """(R-1, 6) predicted tgt->ref transforms + identity tgt -> (R, 3, 4)
    snippet poses re-expressed relative to the first frame (the reference
    protocol, as ``snippet_from_poses`` does on the GT side).

    The network emits M_j = T_j^{-1} T_mid, the transform that maps
    target-frame points into reference frame j (``inverse_warp``'s
    convention). The pose of frame j in target coordinates is its inverse
    A_j = M_j^{-1}; re-anchoring to the first frame gives A_first^{-1} A_j."""
    import torch

    from supervised_dispnet_tpu_torch.ops.warp import pose_vec2mat

    mats = pose_vec2mat(torch.from_numpy(np.asarray(poses_vec, np.float32)),
                        rotation_mode).numpy()
    R = len(poses_vec) + 1
    mid = R // 2
    poses = []  # A_i: pose of frame i in target (mid) coordinates
    j = 0
    for i in range(R):
        if i == mid:
            poses.append(np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32))
        else:
            Rm, tm = mats[j][:, :3], mats[j][:, 3]
            poses.append(np.hstack([Rm.T, (-Rm.T @ tm)[:, None]]))
            j += 1
    R0, t0 = poses[0][:, :3], poses[0][:, 3]
    return np.stack([np.hstack([R0.T @ T[:, :3], (R0.T @ (T[:, 3] - t0))[:, None]])
                     for T in poses])


def load_pose_net(path: str | Path, nb_ref_imgs: int, device):
    """The pose layers of an exp_pose ``.pth.tar`` in a ``PoseExpNet(
    output_exp=False)``, loaded strictly once the explainability decoder's
    keys (``upconv*``, ``predict_mask*``) are dropped, in eval mode on
    ``device``. A directory (an orbax checkpoint) raises ``ValueError``."""
    from supervised_dispnet_tpu_torch.models import PoseExpNet
    from supervised_dispnet_tpu_torch.utils.checkpoint import load_torch_state_dict
    from supervised_dispnet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    sd = {k: v for k, v in load_torch_state_dict(path).items()
          if not k.startswith(("upconv", "predict_mask"))}
    model = PoseExpNet(nb_ref_imgs=nb_ref_imgs, output_exp=False)
    model.load_state_dict(sd, strict=True)
    return model.to(dev).eval()


def main(argv: list[str] | None = None) -> dict[str, float]:
    """Evaluate; prints ATE / RE / n and returns ``evaluate_pose_snippets``'s
    dict."""
    args = build_parser().parse_args(argv)

    import torch

    from supervised_dispnet_tpu_torch.cli.test_disp import norm_stats
    from supervised_dispnet_tpu_torch.data.augment import normalize_images
    from supervised_dispnet_tpu_torch.data.image_resize import resize_area_uint8
    from supervised_dispnet_tpu_torch.kitti_eval.pose_evaluation_utils import (
        evaluate_pose_snippets, read_odometry_poses, snippet_from_poses)
    from supervised_dispnet_tpu_torch.utils.device import resolve_device, set_fp32_math
    from supervised_dispnet_tpu_torch.utils.image_io import read_image

    dev = resolve_device(args.device)
    set_fp32_math()
    nb_refs = args.sequence_length - 1
    model = load_pose_net(args.pretrained_posenet, nb_refs, dev)
    mean, std = (torch.tensor(v, device=dev) for v in norm_stats(args.imagenet_normalization))

    def forward(tgt: np.ndarray, refs: np.ndarray) -> np.ndarray:
        """uint8 snippets to the card, normalised there -> (b, R-1, 6)."""
        t, r = (normalize_images(torch.from_numpy(a).to(dev).to(torch.float32) / 255.0,
                                 mean, std) for a in (tgt, refs))
        with torch.inference_mode():
            _, pose = model(t, [r[:, i] for i in range(nb_refs)])
        return pose.cpu().numpy()

    demi = nb_refs // 2
    B = max(1, args.batch_size)
    gt_snips, pred_snips, vectors = [], [], []
    for seq in args.sequences:
        frames = sorted((Path(args.dataset_dir) / "sequences" / seq / "image_2").glob("*.png"))
        gt_poses = read_odometry_poses(Path(args.dataset_dir) / "poses" / f"{seq}.txt")
        n = min(len(frames), len(gt_poses))
        cache = [resize_area_uint8(read_image(frames[i]), args.img_height,
                                   args.img_width) for i in range(n)]
        centers = list(range(demi, n - demi))
        for c0 in range(0, len(centers), B):
            ids = centers[c0:c0 + B]
            tgt = np.stack([cache[i] for i in ids])
            refs = np.stack([[cache[j] for j in range(i - demi, i + demi + 1) if j != i]
                             for i in ids])
            poses = forward(tgt, refs)
            vectors.append(poses)
            for k, i in enumerate(ids):
                pred_snips.append(pose_vec_to_snippet(poses[k], args.rotation_mode))
                gt_snips.append(snippet_from_poses(gt_poses, np.arange(i - demi, i + demi + 1)))
            if (c0 // B) % 10 == 0:
                print(f"  seq {seq}: {c0 + len(ids)}/{len(centers)} snippets", flush=True)

    results = evaluate_pose_snippets(gt_snips, pred_snips)
    if args.output_dir:
        out = Path(args.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        np.save(out / "predictions.npy", np.stack(pred_snips))
        np.save(out / "pose_vectors.npy", np.concatenate(vectors))
    print(f"\nATE  {results['ate_mean']:.4f} +/- {results['ate_std']:.4f}")
    print(f"RE   {results['re_mean']:.4f} +/- {results['re_std']:.4f}")
    print(f"n    {int(results['n_snippets'])}")
    return results


if __name__ == "__main__":
    main()
