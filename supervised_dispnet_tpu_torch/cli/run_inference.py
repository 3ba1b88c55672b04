"""Folder inference CLI of the port, with the JAX CLI's flag spellings
(``supervised_dispnet_tpu/cli/run_inference.py``; reference
``run_inference.py``): a folder of images -> disparity / depth PNGs and
optional ``.npy`` depth dumps.

  python -m supervised_dispnet_tpu_torch.cli.run_inference \\
      --pretrained dispnet_model_best.pth.tar --network disp_res_50 \\
      --dataset-dir frames/ --output-dir out/ --output-depth --save-npy

PNG and JPEG frames are decoded by the port's own codec
(``utils/image_io.py::read_image``, chosen by the file's signature); a file
it does not decode raises ``ValueError`` naming it. ``--int8`` serves the
int8 path (``ops/quant.py``), calibrated on the folder's first
``8 * --calib-batches`` images, in batches of 8, as the JAX CLI does. Runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from supervised_dispnet_tpu_torch.cli.test_disp import add_int8_flags


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Run disparity inference on a folder of images (PyTorch port, CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--pretrained", required=True,
                   help=".pth.tar (the port's Trainer or the reference)")
    p.add_argument("--network", default="dispnet")
    p.add_argument("--dataset-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--img-height", type=int, default=128)
    p.add_argument("--img-width", type=int, default=416)
    p.add_argument("--output-disp", action="store_true")
    p.add_argument("--output-depth", action="store_true")
    p.add_argument("--save-npy", action="store_true")
    p.add_argument("--img-exts", nargs="+", default=["png", "jpg", "bmp"])
    p.add_argument("--fused-upsample", action="store_true",
                   help="disp_res* / disp_vgg_bn: each decoder stage's 2x "
                        "upsample composed into the conv after it "
                        "(ops/fused_upconv.py; exact); height and width divisible by 32")
    p.add_argument("--imagenet-normalization", action="store_true")
    p.add_argument("--batch-size", type=int, default=8, help="images per forward")
    add_int8_flags(p, "batches of 8 leading images")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs on the CPU")
    return p


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if not (args.output_disp or args.output_depth or args.save_npy):
        args.output_depth = True

    import torch

    from supervised_dispnet_tpu_torch.cli.test_disp import load_model, norm_stats
    from supervised_dispnet_tpu_torch.data.augment import normalize_images
    from supervised_dispnet_tpu_torch.data.image_resize import resize_area
    from supervised_dispnet_tpu_torch.utils.device import resolve_device, set_fp32_math
    from supervised_dispnet_tpu_torch.utils.image_io import read_image
    from supervised_dispnet_tpu_torch.utils.viz import save_depth_png

    dev = resolve_device(args.device)
    set_fp32_math()
    model = load_model(args.pretrained, args.network,
                       fused_upsample=args.fused_upsample, device=dev)
    mean, std = norm_stats(args.imagenet_normalization)

    src = Path(args.dataset_dir)
    dst = Path(args.output_dir)
    dst.mkdir(parents=True, exist_ok=True)
    files = sorted(f for ext in args.img_exts for f in src.glob(f"*.{ext}"))
    print(f"{len(files)} files to test")
    if not files:
        return

    def load(f: Path) -> np.ndarray:
        img = read_image(f).astype(np.float32) / 255.0
        return resize_area(img, args.img_height, args.img_width)

    def batch(chunk: list[Path]) -> torch.Tensor:
        x = torch.from_numpy(np.stack([load(f) for f in chunk])).to(dev)
        return normalize_images(x, mean, std)

    net = model
    if args.int8:
        from supervised_dispnet_tpu_torch.ops.quant import QuantizedModel, calibrate_conv_ranges

        n_calib = min(8 * max(1, args.calib_batches), len(files))
        with torch.inference_mode():
            calib = [batch(files[c:min(c + 8, n_calib)]) for c in range(0, n_calib, 8)]
        ranges = calibrate_conv_ranges(model, calib, percentile=args.percentile)
        print(f"int8 PTQ: calibrated {len(ranges)} ranges on {n_calib} images")
        net = QuantizedModel(model, ranges).to(dev)

    B = max(1, args.batch_size)
    for c0 in range(0, len(files), B):
        chunk = files[c0:c0 + B]
        with torch.inference_mode():
            out = net(batch(chunk))
        direct_depth = not isinstance(out, list)  # FCRN: metric depth
        preds = (out if direct_depth else out[0])[..., 0].cpu().numpy()
        for f, pred in zip(chunk, preds):
            if direct_depth:
                depth = np.maximum(pred, 1e-6)
                disp = 1.0 / depth
            else:
                disp, depth = pred, 1.0 / np.maximum(pred, 1e-6)
            if args.output_disp:
                save_depth_png(dst / f"{f.stem}_disp.png", disp)
            if args.output_depth:
                save_depth_png(dst / f"{f.stem}_depth.png", depth, max_value=80.0)
            if args.save_npy:
                np.save(dst / f"{f.stem}_depth.npy", depth)
    print(f"wrote outputs to {dst}")


if __name__ == "__main__":
    main()
