"""Eigen-split depth evaluation CLI of the port, with the JAX CLI's flag
spellings (``supervised_dispnet_tpu/cli/test_disp.py``):

  python -m supervised_dispnet_tpu_torch.cli.test_disp \\
      --pretrained-dispnet dispnet_model_best.pth.tar --network disp_res_50 \\
      --dataset-dir /data/kitti_raw --dataset-list test_files_eigen.txt \\
      [--classification] [--median-scaling] [--fused-upsample]

Per image (reference: ``test_disp.py::main``): decode, area-resize to the
network input (416x128), normalise, forward in full fp32, depth = 1 / disp
(the soft decode of the bin logits; FCRN's output as it is), linear resize of the prediction to
the GT size, then Garg crop, depth caps, optional median scaling and the
Eigen errors (``kitti_eval/depth_evaluation_utils.py``). A host thread
decodes and resizes batch k + 1 while the card runs batch k, and the
readback lags one batch. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import queue
import threading
from pathlib import Path

import numpy as np

from supervised_dispnet_tpu_torch.cli import parse_args_or_raise

# JAX CLI flags of the int8 serving path, which a later slice ports
LATER_FLAGS = frozenset(("--int8", "--calib-batches", "--percentile"))
LATER_WHERE = "ROADMAP.md Queue A5 (int8 serving)"
METRICS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="KITTI Eigen-split depth evaluation (PyTorch port, CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--pretrained-dispnet", required=True,
                   help=".pth.tar (the port's Trainer or the reference)")
    p.add_argument("--network", default="dispnet")
    p.add_argument("--dataset-dir", required=True, help="KITTI raw root")
    p.add_argument("--dataset-list", required=True,
                   help="Eigen test file list (one image path per line)")
    p.add_argument("--img-height", type=int, default=128)
    p.add_argument("--img-width", type=int, default=416)
    p.add_argument("--min-depth", type=float, default=1e-3)
    p.add_argument("--max-depth", type=float, default=80.0)
    p.add_argument("--no-resize", action="store_true")
    p.add_argument("--classification", action="store_true")
    p.add_argument("--num-bins", type=int, default=64)
    p.add_argument("--median-scaling", action="store_true",
                   help="per-image median scaling (self-supervised models)")
    p.add_argument("--imagenet-normalization", action="store_true")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--output-dir", default=None, help="dump predicted depth .npy")
    p.add_argument("--fused-upsample", action="store_true",
                   help="disp_res* / disp_vgg_bn: each decoder stage's 2x upsample "
                        "composed into the conv after it (ops/fused_upconv.py; "
                        "exact, same checkpoint); height and width divisible by 32")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs on the CPU")
    return p


def load_model(path: str | Path, network: str, head: str = "disp", num_bins: int = 64,
               fused_upsample: bool = False, device: str = "cuda"):
    """The disparity network of a ``.pth.tar``, in eval mode on ``device``.
    A checkpoint with the coarser scales' bin heads builds the multi-scale
    classification model, whose finest logits come first."""
    from supervised_dispnet_tpu_torch.models import get_disp_net
    from supervised_dispnet_tpu_torch.utils.checkpoint import load_torch_state_dict

    sd = load_torch_state_dict(path)
    model = get_disp_net(network, head=head, num_bins=num_bins,
                         multiscale_classification="predict_class2.0.weight" in sd,
                         fused_upsample=fused_upsample, device=device)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def norm_stats(imagenet: bool) -> tuple[tuple, tuple]:
    """(mean, std) of the input normalisation."""
    from supervised_dispnet_tpu_torch.data import augment

    if imagenet:
        return augment.IMAGENET_MEAN, augment.IMAGENET_STD
    return augment.HALF_MEAN, augment.HALF_STD


def main(argv: list[str] | None = None) -> dict[str, float]:
    """Evaluate; prints the metric table and returns ``evaluate_depth``'s
    dict."""
    args = parse_args_or_raise(build_parser(), argv, LATER_FLAGS, LATER_WHERE)

    import torch

    from supervised_dispnet_tpu_torch.data.augment import normalize_images
    from supervised_dispnet_tpu_torch.data.filelist_validation import validate_eigen_list
    from supervised_dispnet_tpu_torch.data.image_resize import resize_area, resize_linear
    from supervised_dispnet_tpu_torch.kitti_eval.depth_evaluation_utils import (
        EvalConfig, KittiEigenFramework, evaluate_depth)
    from supervised_dispnet_tpu_torch.losses.classification import DepthBins
    from supervised_dispnet_tpu_torch.training.train_step import output_depth
    from supervised_dispnet_tpu_torch.utils.device import resolve_device, set_fp32_math

    dev = resolve_device(args.device)
    set_fp32_math()
    head = "classification" if args.classification else "disp"
    model = load_model(args.pretrained_dispnet, args.network, head, args.num_bins,
                       args.fused_upsample, dev)
    bins = DepthBins(num_bins=args.num_bins, max_depth=args.max_depth)
    mean, std = (torch.tensor(v, device=dev) for v in norm_stats(args.imagenet_normalization))

    def forward(imgs: np.ndarray):
        """Queue the batch's upload, forward and readback on the card without
        waiting for the batch before: from and to pinned memory, with the
        normalisation's constants on the card already. Returns (depth on the
        host, the card's event that says it is there, or None on the CPU)."""
        x = torch.from_numpy(imgs)
        if dev.type == "cuda":
            x = x.pin_memory()
        x = normalize_images(x.to(dev, non_blocking=True), mean, std)
        with torch.inference_mode():
            depth = output_depth(model(x), bins if args.classification else None)
        if dev.type != "cuda":
            return depth, None
        host = torch.empty(depth.shape, dtype=depth.dtype, pin_memory=True)
        host.copy_(depth, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    fmt_errors = validate_eigen_list(args.dataset_list, expect_count=False)
    if fmt_errors:
        # warn only: custom lists (non-KITTI layouts) are allowed
        print(f"WARNING: {args.dataset_list} does not look like a canonical "
              f"Eigen list ({fmt_errors[0]})")
    test_files = Path(args.dataset_list).read_text().splitlines()
    framework = KittiEigenFramework(args.dataset_dir, test_files, args.min_depth,
                                    args.max_depth)

    def produce(q: queue.Queue) -> None:
        batch_imgs, batch_gt = [], []
        try:
            for i, sample in enumerate(framework):
                img = sample["img"].astype(np.float32) / 255.0
                if not args.no_resize:
                    img = resize_area(img, args.img_height, args.img_width)
                batch_imgs.append(img)
                batch_gt.append(sample["gt_depth"])
                if len(batch_imgs) == args.batch_size:
                    q.put((np.stack(batch_imgs), batch_gt))
                    batch_imgs, batch_gt = [], []
                if i % 50 == 0:
                    print(f"  {i}/{len(framework)}", flush=True)
            if batch_imgs:
                q.put((np.stack(batch_imgs), batch_gt))
            q.put(None)
        except Exception as e:  # raised again in the main thread
            q.put(e)

    q: queue.Queue = queue.Queue(maxsize=2)
    threading.Thread(target=produce, args=(q,), daemon=True).start()

    gt_list, pred_list = [], []

    def drain(host, event, gts) -> None:
        if event is not None:
            event.synchronize()
        for d, gt in zip(host.numpy(), gts):
            pred_list.append(resize_linear(d, gt.shape[0], gt.shape[1]))
            gt_list.append(gt)

    in_flight = None
    while (item := q.get()) is not None:
        if isinstance(item, Exception):
            raise item
        imgs, gts = item
        readback = forward(imgs)  # the card runs it while the last batch drains
        if in_flight is not None:
            drain(*in_flight)
        in_flight = (*readback, gts)
    if in_flight is not None:
        drain(*in_flight)

    cfg = EvalConfig(min_depth=args.min_depth, max_depth=args.max_depth,
                     median_scaling=args.median_scaling)
    results = evaluate_depth(gt_list, pred_list, cfg)

    if args.output_dir:
        out = Path(args.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        np.save(out / "predictions.npy", np.asarray(pred_list, dtype=object),
                allow_pickle=True)

    print()
    print("".join(f"{n:>10}" for n in METRICS))
    print("".join(f"{results[n]:10.4f}" for n in METRICS))
    return results


if __name__ == "__main__":
    main()
