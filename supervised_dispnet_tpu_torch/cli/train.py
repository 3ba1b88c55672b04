"""Training CLI of the port, with the JAX CLI's flag spellings for the
supervised, depth-as-classification and self-supervised paths
(``supervised_dispnet_tpu/cli/train.py``):

  python -m supervised_dispnet_tpu_torch.cli.train /data/kitti_packed \\
      --network disp_res_50 --loss berhu -b 4 --lr 2e-4 --epochs 80 --with-gt
  python -m supervised_dispnet_tpu_torch.cli.train /data/kitti_packed \\
      --network disp_res_50 --loss classification -b 4 --with-gt
  python -m supervised_dispnet_tpu_torch.cli.train /data/kitti_packed \\
      --network dispnet --loss selfsup --sequence-length 3 -p 1.0 -m 0.2 -s 0.1 -b 4

  python -m supervised_dispnet_tpu_torch.cli.train /data/kitti_packed \\
      --network disp_res_50 --loss berhu -b 4 --bf16 --ema-decay 0.999 \\
      --accum-steps 2 --pretrained-encoder resnet50.pth --imagenet-normalization
  python -m supervised_dispnet_tpu_torch.cli.train /data/kitti_packed \\
      --network dispnet --loss selfsup --stochastic-photo 2 -f 100 \\
      --loader device --steps-per-dispatch 4

Data-parallel on N ranks, one process a rank, through PyTorch's launcher
(``-b`` stays the global batch, which N must divide; rank r trains on the
rows [r B / N, (r + 1) B / N) of each batch; ``parallel/mesh.py``):

  python -m torch.distributed.run --nproc-per-node 2 \
      -m supervised_dispnet_tpu_torch.cli.train /data/kitti_packed \
      --network disp_res_50 --loss berhu -b 8

Rank r runs on ``cuda:{LOCAL_RANK}`` over NCCL, or over gloo where ranks
share a card or run on the CPU (``--device cpu``). Rank 0 alone prints and
writes the logs and checkpoints.

``--spatial-shards S`` also splits the image height over S ranks (the world
is ``N / S`` data ranks x S spatial ranks; ``parallel/spatial.py``), for
inputs whose activations outgrow one card; the height must be a multiple of
the network's deepest stride (32, DispNetS 128) and hold at least S of its
rows. The supervised and classification losses and validation run on it;
``--loss selfsup`` and ``--qat`` raise (ROADMAP A6b-2):

  python -m torch.distributed.run --nproc-per-node 2 \
      -m supervised_dispnet_tpu_torch.cli.train /data/kitti_packed \
      --network disp_res_50 --loss berhu -b 2 --spatial-shards 2

Reads a packed dataset root (``data/packed.py``) or a dump tree of JPEG
frames (``data/prepare_train_data.py``; decoded on the ``-j`` host threads).
Runs on the card unless
``--device cpu`` is given. An option that is not ported yet raises
``NotImplementedError``; it is never ignored.
"""

from __future__ import annotations

import argparse
import datetime
import sys
from pathlib import Path

REMAT_CHOICES = ("full", "conv")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Supervised and self-supervised depth training (PyTorch port, CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("data", help="packed dataset root (data/packed.py layout) or a "
                                "dump tree (data/prepare_train_data.py layout)")
    p.add_argument("--network", default="dispnet",
                   choices=["dispnet", "disp_res", "disp_res_18", "disp_res_50",
                            "disp_vgg_bn", "fcrn"],
                   help="fcrn predicts metric depth (one scale), the others "
                        "disparity at four scales")
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
    p.add_argument("--fused-upsample", action="store_true",
                   help="disp_res* / disp_vgg_bn: each decoder stage's 2x upsample "
                        "composed into the conv after it (ops/fused_upconv.py; "
                        "exact, same state dict); height and width divisible by 32")
    p.add_argument("--pretrained-disp", default=None,
                   help="initialise the disp net from a .pth.tar (the port's "
                        "Trainer or the reference)")
    p.add_argument("--pretrained-exppose", default=None,
                   help="--loss selfsup: initialise the pose net from an exp_pose "
                        ".pth.tar; with -m > 0 it must hold the mask decoder")
    p.add_argument("--pretrained-encoder", default=None,
                   help="disp_res*: initialise the encoder from a torchvision "
                        "ResNet-18/50 state dict (ImageNet weights, BN statistics "
                        "included; fc.* dropped)")
    p.add_argument("--resume", action="store_true",
                   help="continue the newest run under <checkpoints-dir>/<name> "
                        "exactly: models, optimizer, EMA, augmentation generator, "
                        "step, epoch and best metric")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 trunk compute; parameters and the heads stay "
                        "float32 (fcrn has no bf16 trunk and stays float32)")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="> 0 keeps an EMA shadow of the parameters, ticked once an "
                        "update; validation uses it (e.g. 0.999)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="> 1: average the gradients of this many micro-batches into "
                        "one optimizer update (effective batch k * batch-size)")
    p.add_argument("--qat", action="store_true",
                   help="quantization-aware training: fake-quantize every quantizable "
                        "conv of the disp net, so that the checkpoint serves --int8 "
                        "with less quality loss than post-training calibration")
    p.add_argument("--remat", choices=REMAT_CHOICES, default=None,
                   help="activation checkpointing of the disp net's stages (and the "
                        "self-supervised photometric terms): 'full' (also bare "
                        "--remat) recomputes them in the backward, 'conv' saves the "
                        "convolutions' outputs and recomputes the rest")
    p.add_argument("--hue", type=float, default=0.0,
                   help="hue-jitter amplitude (fraction of the colour wheel)")
    p.add_argument("--imagenet-normalization", action="store_true",
                   help="normalise with ImageNet's mean and std, not 0.5 / 0.5")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError at the first non-finite loss or "
                        "gradient (reads a flag from the card every step)")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="> 0: a torch.profiler trace of this many steady-state train "
                        "steps (from the second) into <run>/profile")
    p.add_argument("--half-res-photo", action="store_true",
                   help="compute the photometric loss one octave down (deviates "
                        "from the reference loss)")
    p.add_argument("--stochastic-photo", type=int, default=1, metavar="N",
                   help="evaluate the photometric loss at every N-th pixel per axis "
                        "at a random per-step phase (an unbiased 1/N^2 subsample; "
                        "deviates from the reference loss)")
    p.add_argument("-f", "--training-output-freq", type=int, default=0,
                   help="log disparity (and, self-supervised, warp) images to "
                        "tensorboard every N iterations (a no-op writer where "
                        "tensorboardX does not import)")
    p.add_argument("--loader", default="threads", choices=["threads", "grain", "device"],
                   help="'threads' gathers batches on the host; 'device' keeps the "
                        "packed train split on the card and gathers each batch "
                        "there (a packed root only); 'grain' is the JAX package's "
                        "and is not ported")
    p.add_argument("-j", "--workers", type=int, default=4,
                   help="host threads gathering (a dump tree: decoding) batches "
                        "(the same batches for any count)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="--loader device only: run this many train steps from one "
                        "block of index batches, their metrics read back once "
                        "(logged as means over the block)")
    p.add_argument("--spatial-shards", type=int, default=1,
                   help="> 1: also split the image height over this many ranks (a "
                        "second mesh axis, halo exchanges), for full-resolution inputs "
                        "whose activations outgrow one card; needs height / max-stride "
                        ">= shards and a number of ranks divisible by shards; not with "
                        "--loss selfsup or --qat")
    p.add_argument("--max-depth", type=float, default=80.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--img-height", type=int, default=128,
                   help="accepted for the JAX CLI's spelling: batches keep the "
                        "dataset's frame size")
    p.add_argument("--img-width", type=int, default=416,
                   help="accepted for the JAX CLI's spelling: batches keep the "
                        "dataset's frame size")
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
    """The flags; a bare ``--remat`` means ``--remat full`` and never takes
    the next argument (the data root) as its value."""
    argv = list(sys.argv[1:] if argv is None else argv)
    argv = ["--remat=full" if tok == "--remat" and (i + 1 == len(argv)
                                                    or argv[i + 1] not in REMAT_CHOICES)
            else tok for i, tok in enumerate(argv)]
    return build_parser().parse_args(argv)


def load_pretrained_encoder(model, path: str | Path, network: str) -> None:
    """A torchvision ResNet state dict into ``model``'s encoder
    (``utils/convert.py::convert_resnet_encoder``), BN statistics included;
    the depth is the network's."""
    from supervised_dispnet_tpu_torch.utils.checkpoint import load_torch_state_dict
    from supervised_dispnet_tpu_torch.utils.convert import convert_resnet_encoder

    sd = convert_resnet_encoder(load_torch_state_dict(path),
                                depth=50 if network.endswith("50") else 18)
    missing, unexpected = model.encoder.load_state_dict(sd, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise ValueError(f"{path}: the encoder's state dict does not fit: missing "
                         f"{missing[:4]}, unexpected {unexpected[:4]}")


def run_dir(checkpoints_dir: str | Path, name: str, resume: bool) -> Path:
    """``<checkpoints_dir>/<name>/<timestamp>``; with ``resume``, the newest
    run there, when there is one."""
    root = Path(checkpoints_dir) / name
    if resume:
        runs = sorted(d for d in root.glob("*") if d.is_dir()) if root.is_dir() else []
        if runs:
            return runs[-1]
        print(f"=> --resume: no previous run under {root}, starting fresh")
    return root / datetime.datetime.now().strftime("%m-%d-%H.%M")


def load_pretrained_exppose(pose_model, path: str | Path) -> None:
    """An exp_pose ``.pth.tar`` into ``pose_model``, strictly. Without the
    mask decoder (``output_exp=False``, ``-m 0``) its keys are dropped, as
    the JAX converter drops them; with it, a checkpoint that lacks them
    raises ``ValueError`` naming them (the JAX converter leaves them out and
    its first step fails)."""
    from supervised_dispnet_tpu_torch.utils.checkpoint import load_torch_state_dict

    sd = load_torch_state_dict(path)
    decoder = ("upconv", "predict_mask")
    if not pose_model.output_exp:
        sd = {k: v for k, v in sd.items() if not k.startswith(decoder)}
    missing = sorted(k for k in pose_model.state_dict() if k not in sd)
    if missing:
        raise ValueError(
            f"{path} has no {', '.join(missing[:4])}{' ...' if len(missing) > 4 else ''}: "
            "a pose checkpoint without the explainability decoder loads only with -m 0")
    pose_model.load_state_dict(sd, strict=True)


def main(argv: list[str] | None = None):
    """Train; returns the ``Trainer``. Under ``torch.distributed.run`` this
    process is one rank: it joins the process group first and leaves it at
    the end."""
    args = parse_args(argv)
    if args.pretrained_encoder and not args.network.startswith("disp_res"):
        raise ValueError("--pretrained-encoder applies to disp_res* networks, "
                         f"not {args.network}")

    import torch.distributed as dist

    from supervised_dispnet_tpu_torch.parallel import mesh as parallel
    from supervised_dispnet_tpu_torch.training.train_step import (
        QAT_NOT_SPATIAL, SELFSUP_NOT_SPATIAL)

    if args.spatial_shards > 1 and (args.loss == "selfsup" or args.qat):
        raise NotImplementedError(SELFSUP_NOT_SPATIAL if args.loss == "selfsup"
                                  else QAT_NOT_SPATIAL)
    joins = parallel.launched() and not dist.is_initialized()
    device, mesh = parallel.init_from_env(args.device, args.spatial_shards)
    try:
        return _train(args, device, mesh)
    finally:
        if joins:
            parallel.shutdown()


def _train(args: argparse.Namespace, device, mesh):
    import torch

    from supervised_dispnet_tpu_torch.models import PoseExpNet, get_disp_net
    from supervised_dispnet_tpu_torch.training.trainer import Trainer, TrainerConfig
    from supervised_dispnet_tpu_torch.utils.checkpoint import load_torch_state_dict

    # rank 0's run directory (its clock names a new one) on every rank
    save_path = mesh.broadcast_object(run_dir(args.checkpoints_dir, args.name, args.resume)
                                      if mesh.is_main else None)
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
        smooth_loss_weight=args.smooth_loss_weight,
        imagenet_normalization=args.imagenet_normalization, hue=args.hue,
        bf16=args.bf16, remat=args.remat or False, ema_decay=args.ema_decay,
        accum_steps=args.accum_steps, debug_nans=args.debug_nans, qat=args.qat,
        profile_steps=args.profile_steps, resume=args.resume,
        half_res_photo=args.half_res_photo, stochastic_photo=args.stochastic_photo,
        training_output_freq=args.training_output_freq, loader=args.loader,
        workers=args.workers, steps_per_dispatch=args.steps_per_dispatch,
        spatial_shards=args.spatial_shards)
    head = "classification" if args.loss == "classification" else "disp"
    model = get_disp_net(args.network, head=head, num_bins=args.num_bins,
                         multiscale_classification=args.multiscale_classification,
                         fused_upsample=args.fused_upsample, remat=args.remat,
                         seed=args.seed, device=device)
    pose_model = None
    if args.loss == "selfsup":
        # a stream of its own, so the disp net's weights do not depend on it
        pose_model = PoseExpNet(nb_ref_imgs=args.sequence_length - 1,
                                output_exp=args.mask_loss_weight > 0,
                                generator=torch.Generator().manual_seed(args.seed + 1))
    if args.pretrained_disp:
        model.load_state_dict(load_torch_state_dict(args.pretrained_disp), strict=True)
    if args.pretrained_encoder:
        load_pretrained_encoder(model, args.pretrained_encoder, args.network)
    if args.pretrained_exppose:
        if pose_model is None:
            raise ValueError("--pretrained-exppose needs --loss selfsup")
        load_pretrained_exppose(pose_model, args.pretrained_exppose)
    trainer = Trainer(cfg, model, pose_model, device=device, mesh=mesh)
    if mesh.is_main:
        print(f"=> saving to {save_path}")
    best = trainer.fit()
    metric = "abs_rel" if trainer.val_with_gt else "photo_loss"
    if mesh.is_main:
        print(f"=> best val {metric} {best:.4f}")
    return trainer


if __name__ == "__main__":
    main()
