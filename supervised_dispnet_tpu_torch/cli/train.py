"""Training CLI of the port, with the JAX CLI's flag spellings for the
supervised, depth-as-classification and self-supervised paths
(``supervised_dispnet_tpu/cli/train.py``):

  python -m supervised_dispnet_tpu_torch.cli.train /data/kitti_packed \\
      --network disp_res_50 --loss berhu -b 4 --lr 2e-4 --epochs 80 --with-gt
  python -m supervised_dispnet_tpu_torch.cli.train /data/kitti_packed \\
      --network disp_res_50 --loss classification -b 4 --with-gt
  python -m supervised_dispnet_tpu_torch.cli.train /data/kitti_packed \\
      --network dispnet --loss selfsup --sequence-length 3 -p 1.0 -m 0.2 -s 0.1 -b 4

Reads packed datasets (``data/packed.py``). Runs on the card unless
``--device cpu`` is given. A JAX flag whose feature is not ported yet raises
``NotImplementedError``; it is never ignored.
"""

from __future__ import annotations

import argparse
import datetime
from pathlib import Path

# JAX CLI flags of features that later slices port (see ROADMAP.md)
_LATER_FLAGS = frozenset((
    "--ema-decay", "--imagenet-normalization", "--hue", "--half-res-photo",
    "--stochastic-photo", "--bf16", "--remat",
    "--fused-upsample", "--qat", "--debug-nans", "--loader",
    "--steps-per-dispatch", "--accum-steps", "--spatial-shards",
    "--profile-steps", "-f", "--training-output-freq", "--pretrained-disp",
    "-j", "--workers",
    "--pretrained-exppose", "--pretrained-encoder", "--resume",
))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Supervised and self-supervised depth training (PyTorch port, CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("data", help="packed dataset root (data/packed.py layout)")
    p.add_argument("--network", default="dispnet",
                   choices=["dispnet", "disp_res", "disp_res_18", "disp_res_50",
                            "disp_vgg_bn", "fcrn"],
                   help="dispnet and disp_res* are ported; the others raise")
    p.add_argument("--loss", default="berhu",
                   choices=["l1", "berhu", "scale_invariant", "classification",
                            "selfsup"],
                   help="classification trains the bin-logit head (disp_res* only)")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--epoch-size", type=int, default=0,
                   help="limit batches per epoch (0 = full)")
    p.add_argument("-b", "--batch-size", type=int, default=4)
    p.add_argument("--lr", "--learning-rate", type=float, default=2e-4)
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "step", "cosine"])
    p.add_argument("--lr-warmup-steps", type=int, default=0,
                   help="linear 0->lr warmup, in optimizer steps")
    p.add_argument("--lr-decay-steps", type=int, default=0,
                   help="step: staircase period; cosine: total decay span")
    p.add_argument("--lr-decay-rate", type=float, default=0.5,
                   help="decay factor per period for --lr-schedule step")
    p.add_argument("--momentum", type=float, default=0.9,
                   help="adam beta1 (reference flag name)")
    p.add_argument("--beta", type=float, default=0.999,
                   help="adam beta2 (reference flag name)")
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="> 0: AdamW with this decoupled weight decay")
    p.add_argument("--with-gt", action="store_true",
                   help="accepted for flag compatibility: validation uses GT "
                        "depth when the val split has it, else the "
                        "self-supervised losses")
    p.add_argument("--sequence-length", type=int, default=3,
                   help="snippet length for --loss selfsup")
    p.add_argument("--rotation-mode", default="euler", choices=["euler", "quat"])
    p.add_argument("--padding-mode", default="zeros", choices=["zeros", "border"])
    p.add_argument("-p", "--photo-loss-weight", type=float, default=1.0)
    p.add_argument("-m", "--mask-loss-weight", type=float, default=0.2,
                   help="explainability weight; 0 builds the pose net without masks")
    p.add_argument("-s", "--smooth-loss-weight", type=float, default=0.1)
    p.add_argument("--num-bins", type=int, default=64)
    p.add_argument("--multiscale-classification", action="store_true",
                   help="supervise bin logits at all 4 decoder scales "
                        "(classification head)")
    p.add_argument("--max-depth", type=float, default=80.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--img-height", type=int, default=128,
                   help="JPEG dump trees only: a packed split keeps its own size")
    p.add_argument("--img-width", type=int, default=416,
                   help="JPEG dump trees only: a packed split keeps its own size")
    p.add_argument("--use-pallas-losses", action="store_true",
                   help="accepted for flag compatibility: BerHu and the "
                        "classification CE on the card always run the CUDA "
                        "kernels")
    p.add_argument("--use-pallas-warp", action="store_true",
                   help="accepted for flag compatibility: the warp on the "
                        "card always runs the CUDA kernels")
    p.add_argument("--name", default="exp", help="experiment name")
    p.add_argument("--checkpoints-dir", default="checkpoints")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions on the CPU")
    return p


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    for tok in unknown:
        flag = tok.split("=", 1)[0]
        if flag in _LATER_FLAGS:
            raise NotImplementedError(f"{flag} is not ported yet; see ROADMAP.md")
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    return args


def main(argv: list[str] | None = None):
    """Train; returns the ``Trainer``."""
    args = parse_args(argv)

    import torch

    from supervised_dispnet_tpu_torch.models import PoseExpNet, get_disp_net
    from supervised_dispnet_tpu_torch.training.trainer import Trainer, TrainerConfig

    timestamp = datetime.datetime.now().strftime("%m-%d-%H.%M")
    save_path = Path(args.checkpoints_dir) / args.name / timestamp
    cfg = TrainerConfig(
        data=args.data, save_path=str(save_path), loss=args.loss, epochs=args.epochs, epoch_size=args.epoch_size,
        batch_size=args.batch_size, lr=args.lr, beta1=args.momentum,
        beta2=args.beta, weight_decay=args.weight_decay, max_depth=args.max_depth,
        num_bins=args.num_bins, seed=args.seed,
        lr_schedule=args.lr_schedule, lr_warmup_steps=args.lr_warmup_steps,
        lr_decay_steps=args.lr_decay_steps, lr_decay_rate=args.lr_decay_rate,
        sequence_length=args.sequence_length, rotation_mode=args.rotation_mode,
        padding_mode=args.padding_mode, photo_loss_weight=args.photo_loss_weight,
        mask_loss_weight=args.mask_loss_weight,
        smooth_loss_weight=args.smooth_loss_weight)
    head = "classification" if args.loss == "classification" else "disp"
    model = get_disp_net(args.network, head=head, num_bins=args.num_bins,
                         multiscale_classification=args.multiscale_classification,
                         seed=args.seed, device=args.device)
    pose_model = None
    if args.loss == "selfsup":
        # a stream of its own, so the disp net's weights do not depend on it
        pose_model = PoseExpNet(nb_ref_imgs=args.sequence_length - 1,
                                output_exp=args.mask_loss_weight > 0,
                                generator=torch.Generator().manual_seed(args.seed + 1))
    trainer = Trainer(cfg, model, pose_model, device=args.device)
    print(f"=> saving to {save_path}")
    best = trainer.fit()
    metric = "abs_rel" if trainer.val_with_gt else "photo_loss"
    print(f"=> best val {metric} {best:.4f}")
    return trainer


if __name__ == "__main__":
    main()
