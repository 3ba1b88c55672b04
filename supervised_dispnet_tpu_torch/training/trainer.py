"""Epoch-level training loop, the port of the supervised (regression and
depth-as-classification) and self-supervised paths of
``supervised_dispnet_tpu/training/trainer.py``:
per-epoch train pass, validation against GT depth (or, without GT, with the
self-supervised losses), CSV/JSONL logs, and checkpoints with a best-copy
when the validation metric improves; with the JAX trainer's options: a
bf16 trunk, an EMA shadow that validation uses, gradient accumulation, an
exact resume, hue jitter and ImageNet normalisation, the remat, half-res
and stochastic photometric terms, a NaN check, a trace of steady-state
steps, training-output images, and the loaders: host threads, or the split
held on the device (``--loader device``) with k steps a dispatch; and
data-parallel over the ranks of a process group (``parallel/mesh.py``): each
rank loads and trains on its rows of the global batch, and rank 0 alone
prints and writes the logs, checkpoints and traces. With
``spatial_shards`` S > 1 the ranks form a ``data x spatial`` mesh: the S
ranks of a spatial group load the same batch rows and each trains on a band
of the image rows (``parallel/spatial.py``; supervised, classification and
validation steps).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from supervised_dispnet_tpu_torch.data.augment import (
    HALF_MEAN, HALF_STD, IMAGENET_MEAN, IMAGENET_STD, AugmentConfig, normalize_images)
from supervised_dispnet_tpu_torch.data.device_cache import DeviceResidentSequence
from supervised_dispnet_tpu_torch.data.loader import BatchLoader
from supervised_dispnet_tpu_torch.data.packed import (
    PackedSequenceDataset, PackedValidationSet, is_packed)
from supervised_dispnet_tpu_torch.data.sequence_folders import SequenceFolder
from supervised_dispnet_tpu_torch.data.validation_folders import ValidationSet
from supervised_dispnet_tpu_torch.losses.classification import DepthBins
from supervised_dispnet_tpu_torch.models.common import set_compute_dtype
from supervised_dispnet_tpu_torch.ops.warp import inverse_warp
from supervised_dispnet_tpu_torch.parallel.mesh import Mesh, make_mesh
from supervised_dispnet_tpu_torch.training.train_step import (
    SUPERVISED_LOSSES, disps_to_depths, imgs_to_float,
    make_eval_step, make_selfsup_eval_step, make_selfsup_train_step,
    make_supervised_train_step, output_depth)
from supervised_dispnet_tpu_torch.utils.checkpoint import load_torch_state_dict, save_linked
from supervised_dispnet_tpu_torch.utils.device import resolve_device, set_fp32_math
from supervised_dispnet_tpu_torch.utils.logging import (
    AverageMeter, CsvLogger, JsonlLogger, NoopWriter, TermLogger, make_tensorboard_writer)
from supervised_dispnet_tpu_torch.utils.profiling import trace
from supervised_dispnet_tpu_torch.utils.viz import tensor2array

CHECKPOINT_NAME = "dispnet_checkpoint.pth.tar"
BEST_NAME = "dispnet_model_best.pth.tar"
POSE_CHECKPOINT_NAME = "exp_pose_checkpoint.pth.tar"
POSE_BEST_NAME = "exp_pose_model_best.pth.tar"


@dataclasses.dataclass
class TrainerConfig:
    """The supervised, classification and self-supervised fields of the JAX
    ``TrainerConfig``, and its training options."""

    data: str = ""
    save_path: str = "checkpoints/exp"
    loss: str = "berhu"  # l1 | berhu | scale_invariant | classification | selfsup
    epochs: int = 200
    epoch_size: int = 0  # 0 = full epoch
    batch_size: int = 4
    lr: float = 2e-4
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0  # > 0: AdamW
    max_depth: float = 80.0
    num_bins: int = 64  # depth bins of loss="classification"
    seed: int = 0
    # self-supervised (loss="selfsup")
    sequence_length: int = 3
    rotation_mode: str = "euler"  # euler | quat
    padding_mode: str = "zeros"  # zeros | border
    photo_loss_weight: float = 1.0
    mask_loss_weight: float = 0.2
    smooth_loss_weight: float = 0.1
    with_exp_mask: bool = True
    # learning-rate schedule, in optimizer steps
    lr_schedule: str = "constant"  # constant | step | cosine
    lr_warmup_steps: int = 0  # linear 0 -> lr warmup
    lr_decay_steps: int = 0  # step: staircase period; cosine: total decay span
    lr_decay_rate: float = 0.5  # step schedule decay factor per period
    # training options
    imagenet_normalization: bool = False  # ImageNet mean / std, not 0.5 / 0.5
    hue: float = 0.0  # hue-jitter amplitude (fraction of the colour wheel)
    bf16: bool = False  # bf16 trunk compute; parameters and heads stay fp32
    remat: bool | str = False  # --remat: the CLI builds the disp net with
    #   activation checkpointing; this also checkpoints the photometric terms
    ema_decay: float = 0.0  # > 0: an EMA shadow that validation uses
    accum_steps: int = 1  # > 1: k micro-batches an optimizer update
    debug_nans: bool = False  # raise at the first non-finite loss or gradient
    qat: bool = False  # quantization-aware training: fake-quant every
    #   quantizable conv of the disp net (ops/quant.py::fake_quant_methods)
    profile_steps: int = 0  # > 0: trace this many steady-state steps
    resume: bool = False  # continue save_path's last checkpoint exactly
    half_res_photo: bool = False  # the photometric pyramid one octave down
    stochastic_photo: int = 1  # > 1: the photometric term at every N-th pixel
    #   per axis, at a phase drawn each step (unbiased; losses/selfsup.py)
    training_output_freq: int = 0  # > 0: disp / warp images every N iterations
    loader: str = "threads"  # threads (BatchLoader) | device (the split on the card)
    workers: int = 4  # BatchLoader's gather threads
    steps_per_dispatch: int = 1  # loader="device": k steps from one block of
    #   k index batches, their metrics read back once (logged as means)
    spatial_shards: int = 1  # > 1: image height over a spatial mesh axis of
    #   this many ranks (parallel/spatial.py); the world must be a multiple


def aug_config(cfg: TrainerConfig) -> AugmentConfig:
    """The augmentation of ``cfg``: its hue and normalisation."""
    mean, std = ((IMAGENET_MEAN, IMAGENET_STD) if cfg.imagenet_normalization
                 else (HALF_MEAN, HALF_STD))
    return AugmentConfig(mean=mean, std=std, hue=cfg.hue)


def build_lr_schedule(cfg: TrainerConfig):
    """step -> learning rate, as the JAX package's optax schedules give it
    (``constant_schedule``, ``exponential_decay(staircase=True)``,
    ``cosine_decay_schedule``, after an optional linear warmup)."""
    lr = cfg.lr
    if cfg.lr_schedule == "constant":
        def base(s):
            return lr
    elif cfg.lr_schedule in ("step", "cosine"):
        if cfg.lr_decay_steps <= 0:
            raise ValueError(f"lr_schedule={cfg.lr_schedule!r} requires lr_decay_steps > 0")
        T = cfg.lr_decay_steps
        if cfg.lr_schedule == "step":
            def base(s):
                return lr * cfg.lr_decay_rate ** (max(s, 0) // T)
        else:
            def base(s):
                return lr * 0.5 * (1.0 + math.cos(math.pi * min(max(s, 0), T) / T))
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    W = cfg.lr_warmup_steps
    if W > 0:
        return lambda s: lr * min(max(s, 0), W) / W if s < W else base(s - W)
    return base


def build_optimizer(cfg: TrainerConfig, params) -> torch.optim.Optimizer:
    """Adam as ``optax.adam(lr, b1, b2)`` computes it (eps 1e-8 outside the
    square root); AdamW when ``weight_decay > 0``."""
    if cfg.weight_decay > 0:
        return torch.optim.AdamW(params, lr=cfg.lr, betas=(cfg.beta1, cfg.beta2),
                                 eps=1e-8, weight_decay=cfg.weight_decay)
    return torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8)


class Trainer:
    """Training of ``disp_model`` (and, for ``loss='selfsup'``, of
    ``pose_model`` beside it, under one optimizer) on ``device`` (the card
    unless the caller passes ``device='cpu'``).

    ``step`` counts optimizer updates; ``update.micro_step`` the train steps
    (micro-batches), the JAX ``state.step``, which the logs use. With
    ``cfg.bf16`` the networks that have a bf16 trunk compute in it, as the
    JAX trainer's ``clone(dtype=bfloat16)``; one without (FCRN) says so and
    stays float32.

    ``mesh`` is the mesh (default: the process group this process joined,
    ``parallel.mesh.make_mesh(cfg.spatial_shards)``; one rank without one).
    ``cfg.batch_size`` is the global batch, which the ranks of the data
    axis must divide: each trains on its rows, with the augmentation
    generator seeded alike on every rank. On a spatial axis the
    self-supervised loss and QAT raise ``NotImplementedError`` (ROADMAP
    A6b-2)."""

    def __init__(self, cfg: TrainerConfig, disp_model: torch.nn.Module,
                 pose_model: torch.nn.Module | None = None,
                 device: str | torch.device = "cuda", mesh: Mesh | None = None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(cfg.spatial_shards)
        if self.mesh.spatial != cfg.spatial_shards:
            raise ValueError(f"the mesh has {self.mesh.spatial} spatial shard(s), the config "
                             f"{cfg.spatial_shards}")
        if cfg.batch_size % self.mesh.data_size:
            raise ValueError(
                f"--batch-size {cfg.batch_size} (the global batch) is not divisible by the "
                f"{self.mesh.data_size} ranks of the data axis; launch a number of ranks "
                "that divides it")
        set_fp32_math()
        self.selfsup = cfg.loss == "selfsup"
        self.classification = cfg.loss == "classification"
        if not (self.selfsup or self.classification) and cfg.loss not in SUPERVISED_LOSSES:
            raise NotImplementedError(
                f"loss {cfg.loss!r} is not ported yet; see ROADMAP.md")
        if self.selfsup and pose_model is None:
            raise ValueError("loss='selfsup' needs a pose_model")
        self.cfg = cfg
        self.model = disp_model.to(self.device)
        self.pose_model = pose_model.to(self.device) if self.selfsup else None
        if cfg.bf16:
            for net in (self.model, self.pose_model):
                if (net is not None and not set_compute_dtype(net, torch.bfloat16)
                        and self.mesh.is_main):
                    print(f"=> --bf16: {type(net).__name__} has no bf16 trunk (nor has "
                          "the JAX package's); it trains in float32")
        params = list(self.model.parameters())
        if self.selfsup:
            params += list(self.pose_model.parameters())
        self.optimizer = build_optimizer(cfg, params)
        self.lr_schedule = build_lr_schedule(cfg)
        self.aug = aug_config(cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        # the stochastic photometric phases, drawn on the host
        self.photo_generator = torch.Generator().manual_seed(cfg.seed)
        self.tb = None  # the image writer: fit makes one unless one is set
        self._device_data: DeviceResidentSequence | None = None  # loader="device"
        self.val_with_gt = True  # set by make_loaders
        self._profiled = False  # the --profile-steps trace is written
        self.bins = DepthBins(num_bins=cfg.num_bins, max_depth=cfg.max_depth)
        self.eval_step = make_eval_step(self.model, classification=self.classification,
                                        bins=self.bins, max_depth=cfg.max_depth, aug=self.aug,
                                        mesh=self.mesh)
        if self.selfsup:
            self._train_step = make_selfsup_train_step(
                self.model, self.pose_model, self.optimizer,
                nb_ref_imgs=cfg.sequence_length - 1, photo_weight=cfg.photo_loss_weight,
                mask_weight=cfg.mask_loss_weight if cfg.with_exp_mask else 0.0,
                smooth_weight=cfg.smooth_loss_weight, rotation_mode=cfg.rotation_mode,
                padding_mode=cfg.padding_mode, aug=self.aug, ema_decay=cfg.ema_decay,
                accum_steps=cfg.accum_steps, debug_nans=cfg.debug_nans, fake_quant=cfg.qat,
                remat_photo=bool(cfg.remat), half_res_photo=cfg.half_res_photo,
                stochastic_photo=cfg.stochastic_photo,
                photo_generator=self.photo_generator, mesh=self.mesh)
            self.selfsup_eval_step = make_selfsup_eval_step(
                self.model, self.pose_model, nb_ref_imgs=cfg.sequence_length - 1,
                rotation_mode=cfg.rotation_mode, padding_mode=cfg.padding_mode,
                with_exp=cfg.with_exp_mask and cfg.mask_loss_weight > 0, aug=self.aug,
                mesh=self.mesh)
        else:
            self._train_step = make_supervised_train_step(
                self.model, self.optimizer, cfg.loss, bins=self.bins, aug=self.aug,
                max_depth=cfg.max_depth, ema_decay=cfg.ema_decay,
                accum_steps=cfg.accum_steps, debug_nans=cfg.debug_nans,
                fake_quant=cfg.qat, mesh=self.mesh)
        # accumulation, the EMA shadow and the NaN check
        self.update = self._train_step.update

    @property
    def step(self) -> int:
        """Optimizer updates taken."""
        return self.update.updates

    def to_device(self, np_batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in np_batch.items()}

    def prep_train_batch(self, np_batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """uint8 images, fp16 depth: half the depth bytes to the card; exact for
        the sparse zeros, < 0.05% relative below 80 m. Self-supervised
        batches carry the reference frames and no depth. With
        ``loader="device"`` the batch is an index dict, and it is gathered
        on the card from the resident split."""
        if self._device_data is not None:
            return self._device_data.gather(self._device_data.upload(np_batch))
        if self.selfsup:
            return self.to_device({k: np_batch[k] for k in ("tgt", "ref_imgs", "intrinsics")})
        return self.to_device({"tgt": np_batch["tgt"],
                               "intrinsics": np_batch["intrinsics"],
                               "depth": np_batch["depth"].astype(np.float16)})

    def train_step(self, batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """One train step (micro-step); its optimizer update, on every
        ``accum_steps``-th, at the scheduled learning rate (the schedule
        ticks once an update, as under ``optax.MultiSteps``)."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(self.step)
        return self._train_step(batch, self.generator)

    def train_item(self, item: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """The steps of one loader item: one batch, or with
        ``steps_per_dispatch`` k > 1 a block of k index batches, uploaded in
        one copy, whose k steps return the means of their metrics (one
        readback for the k steps, as the JAX ``lax.scan`` arm logs them)."""
        k = self.cfg.steps_per_dispatch
        if self._device_data is None or k == 1:
            return self.train_step(self.prep_train_batch(item))
        idx = self._device_data.upload(item)
        runs = [self.train_step(self._device_data.gather({n: v[j] for n, v in idx.items()}))
                for j in range(k)]
        return {n: torch.stack([m[n] for m in runs]).mean() for n in runs[0]}

    @torch.no_grad()
    def predict(self, images) -> np.ndarray:
        """(B, H, W, 3) images in [0, 1] -> (B, H, W) finest-scale disparity;
        for the classification head and for a depth network (FCRN), 1 /
        max(depth, 1e-3). With EMA, from the shadow."""
        imgs = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        self.model.eval()
        with self.update.ema_params():
            out = self.model(normalize_images(imgs, self.aug.mean, self.aug.std))
        if isinstance(out, list) and not self.classification:
            return out[0][..., 0].cpu().numpy()
        depth = output_depth(out, self.bins if self.classification else None)
        return (1.0 / depth.clamp(min=1e-3)).cpu().numpy()

    # -- data ---------------------------------------------------------------
    def make_loaders(self) -> tuple[BatchLoader | DeviceResidentSequence, BatchLoader]:
        """The train loader (host threads, or with ``loader="device"`` the
        split on the card, yielding index dicts) and the validation loader,
        always on the host; each yields this rank's rows of the global
        batches."""
        cfg = self.cfg
        if cfg.loader == "grain":
            raise NotImplementedError(
                "--loader grain (a multi-process pipeline of the JAX package, "
                "supervised_dispnet_tpu/data/grain_loader.py) is not ported; use "
                "--loader threads or --loader device")
        if cfg.loader not in ("threads", "device"):
            raise ValueError(f"unknown loader {cfg.loader!r}")
        if cfg.steps_per_dispatch < 1 or (cfg.steps_per_dispatch > 1
                                          and cfg.loader != "device"):
            raise ValueError(f"steps_per_dispatch={cfg.steps_per_dispatch} needs "
                             "loader='device' (and must be >= 1)")
        packed = is_packed(cfg.data)
        if packed:
            sequences, validation = PackedSequenceDataset, PackedValidationSet
        elif cfg.loader == "device":
            raise ValueError(
                "--loader device requires a packed dataset root: pack the dump "
                "first: python -m supervised_dispnet_tpu_torch.data.packed "
                f"{cfg.data} <out_root>")
        else:
            # a dump tree (data/prepare_train_data.py): frames decoded on the
            # -j threads of the host loader
            sequences, validation = SequenceFolder, ValidationSet
        # supervised training never reads the reference frames
        seq = dict(sequence_length=cfg.sequence_length if self.selfsup else 1,
                   with_depth=not self.selfsup)
        rows = self.mesh.rows(cfg.batch_size)
        if cfg.loader == "device":
            self._device_data = train_loader = DeviceResidentSequence(
                cfg.data, cfg.batch_size, self.device, train=True, seed=cfg.seed,
                epoch_size=cfg.epoch_size or None, steps_per_item=cfg.steps_per_dispatch,
                rows=rows, **seq)
        else:
            train_loader = BatchLoader(
                sequences(cfg.data, seed=cfg.seed, train=True, uint8=True, **seq),
                cfg.batch_size, shuffle=True, num_workers=cfg.workers, seed=cfg.seed,
                epoch_size=cfg.epoch_size or None, rows=rows)
        try:
            val_set = validation(cfg.data, uint8=True)
        except FileNotFoundError:  # a packed val split without GT depth
            val_set = None
        self.val_with_gt = val_set is not None and len(val_set) >= cfg.batch_size
        if not self.val_with_gt:
            if not self.selfsup:
                raise RuntimeError(
                    "no val split with GT depth for a whole batch, and "
                    "not self-supervised: validation needs GT depth")
            # no GT depth: validate with the self-supervised losses
            val_set = sequences(cfg.data, seed=cfg.seed, train=False,
                                sequence_length=cfg.sequence_length, shuffle=False, uint8=True)
        val_loader = BatchLoader(val_set, cfg.batch_size, shuffle=False,
                                 num_workers=cfg.workers, rows=rows)
        return train_loader, val_loader

    # -- loops --------------------------------------------------------------
    def train_epoch(self, loader, logger: TermLogger, csv: CsvLogger,
                    jsonl: JsonlLogger) -> float:
        meter = AverageMeter(precision=4)
        t_data = AverageMeter(precision=3)
        t_batch = AverageMeter(precision=3)
        end = time.time()
        step0 = self.update.micro_step
        k = self.cfg.steps_per_dispatch
        freq = self.cfg.training_output_freq

        def consume(i: int, metrics) -> None:
            # read one item late: item i's loss is read after item i+1 is
            # queued, so the host never leaves the card idle waiting on it
            loss = float(metrics["loss"])
            meter.update(loss)
            csv.write_iter([loss])
            logger.train_update(i, f"batch {t_batch} data {t_data} loss {meter}")
            jsonl.log(event="train_iter", step=step0 + (i + 1) * k, loss=loss)

        # --profile-steps: steps 1 .. prof (step 0 builds the kernels and
        # picks cuDNN's algorithms), the window clamped to the epoch; rank 0's
        prof = (0 if self._profiled or not self.mesh.is_main
                else min(self.cfg.profile_steps, len(loader) - 1))
        pending = None
        with contextlib.ExitStack() as tracing:
            for i, np_batch in enumerate(loader):
                t_data.update(time.time() - end)
                if prof > 0 and i == 1:
                    tracing.enter_context(trace(Path(self.cfg.save_path) / "profile",
                                                self.device))
                metrics = self.train_item(np_batch)
                if prof > 0 and i == prof:
                    tracing.close()
                    self._profiled = True
                    print(f"=> wrote a torch.profiler trace of {prof} steps to "
                          f"{Path(self.cfg.save_path) / 'profile'}", flush=True)
                if pending is not None:
                    consume(*pending)
                pending = (i, metrics)
                t_batch.update(time.time() - end)
                end = time.time()
                if self.tb is not None and freq and i % freq == 0 and self.mesh.is_main:
                    self.log_images(np_batch, step0 + (i + 1) * k)
        if pending is not None:
            consume(*pending)
        return meter.avg[0]

    @torch.no_grad()
    def log_images(self, item: dict[str, np.ndarray], step: int) -> None:
        """The JAX trainer's training-output images (reference: the
        tensorboard images of ``train.py``), written to ``self.tb``: the
        first snippet's finest disparity (train/disp) and its input
        (train/input), and for self-supervised training its first reference
        frame inverse-warped into it (train/warped) with the masked
        difference (train/diff). A B=1 forward of the live weights in eval
        mode outside the train step, so the images exist under ``--remat``
        too; on the card the warp is one single-problem forward launch."""
        if self._device_data is not None:
            # an index dict, (k, B)-stacked under steps_per_dispatch: the
            # first snippet, gathered from the resident split
            k = self.cfg.steps_per_dispatch
            first = {n: (v[0] if k > 1 else v)[:1] for n, v in item.items()}
            batch = self._device_data.gather(self._device_data.upload(first))
        else:
            batch = {n: torch.from_numpy(np.ascontiguousarray(item[n][:1])).to(self.device)
                     for n in ("tgt", "ref_imgs", "intrinsics")}
        img, intr = batch["tgt"], batch["intrinsics"]
        refs = batch["ref_imgs"] if self.selfsup else None
        img = imgs_to_float(img)
        tgt_n = normalize_images(img, self.aug.mean, self.aug.std)
        self.model.eval()
        out = self.model(tgt_n)
        if self.classification:
            disp = 1.0 / output_depth(out, self.bins).clamp(min=1e-3)
        elif isinstance(out, list):
            disp = out[0][..., 0]
        else:
            disp = 1.0 / out[..., 0].clamp(min=1e-3)
        self.tb.add_image("train/disp", tensor2array(disp[0].cpu().numpy()).transpose(2, 0, 1),
                          step)
        img0 = img[0].cpu().numpy()
        self.tb.add_image("train/input", img0.transpose(2, 0, 1), step)
        if refs is None:
            return
        refs = imgs_to_float(refs)
        refs_n = normalize_images(refs, self.aug.mean, self.aug.std)
        self.pose_model.eval()
        _, pose = self.pose_model(tgt_n, [refs_n[:, r] for r in range(refs.shape[1])])
        warped, valid = inverse_warp(refs[:, 0], disps_to_depths(out[:1])[0], pose[:, 0],
                                     intr.to(torch.float32), self.cfg.rotation_mode,
                                     self.cfg.padding_mode)
        warped = warped[0].cpu().numpy()
        diff = np.abs(img0 - warped).mean(-1) * valid[0].cpu().numpy()
        self.tb.add_image("train/warped", np.clip(warped, 0, 1).transpose(2, 0, 1), step)
        self.tb.add_image("train/diff", tensor2array(diff, max_value=1.0).transpose(2, 0, 1),
                          step)

    def validate(self, loader, logger: TermLogger) -> dict[str, float]:
        """Validation against GT, or with the self-supervised losses when
        the val split has no GT, with the EMA shadow when there is one; sums
        stay on the card, read back once."""
        sums: dict[str, torch.Tensor] = {}
        n = 0
        with self.update.ema_params():
            for i, np_batch in enumerate(loader):
                if self.val_with_gt:
                    out = self.eval_step(self.to_device(
                        {"img": np_batch["img"],
                         "depth": np_batch["depth"].astype(np.float16)}))
                else:
                    out = self.selfsup_eval_step(self.to_device(
                        {k: np_batch[k] for k in ("tgt", "ref_imgs", "intrinsics")}))
                for k, v in out.items():
                    sums[k] = sums[k] + v if k in sums else v
                n += 1
                logger.valid_update(i)
        return {k: float(v) / max(n, 1) for k, v in sums.items()}

    def save_checkpoint(self, save_path: Path, epoch: int, is_best: bool,
                        best: float = math.inf) -> None:
        """The disp model's live weights (``state_dict``, reference layout:
        what the eval CLIs load, as the JAX eval loads ``params``), the
        optimizer, the augmentation and photometric-phase generators, the
        step and micro-step, the
        EMA shadow of both nets' parameters by name (``ema``, or None), a
        partial gradient accumulation (``acc``, or None), the epoch and the
        best validation metric; the pose net's ``state_dict`` beside it
        under the reference's name; each linked to its best file when
        ``is_best`` (``utils.checkpoint.save_linked``). ``restore`` reads it
        all back. Rank 0 writes; every rank then waits for it."""
        if self.mesh.is_main:
            save_linked(
                {"epoch": epoch, "step": self.step, "best": best,
                 "state_dict": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(),
                 "generator": self.generator.get_state(),
                 "photo_generator": self.photo_generator.get_state(),
                 **self.update.state_dict()},
                save_path / CHECKPOINT_NAME, save_path / BEST_NAME if is_best else None)
            if self.selfsup:
                save_linked({"epoch": epoch, "state_dict": self.pose_model.state_dict()},
                            save_path / POSE_CHECKPOINT_NAME,
                            save_path / POSE_BEST_NAME if is_best else None)
        self.mesh.barrier()

    def restore(self, save_path: Path) -> dict | None:
        """Load the run's last checkpoint (``save_checkpoint``) into the
        models, optimizer, generator, step, EMA shadow and accumulation;
        returns its ``epoch`` and ``best``, or None when the run has none. A
        checkpoint without a shadow (written without EMA) re-seeds it from
        the loaded weights, as the JAX restore does."""
        path = save_path / CHECKPOINT_NAME
        if not path.is_file():
            return None
        blob = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(blob["state_dict"], strict=True)
        if self.selfsup:
            self.pose_model.load_state_dict(
                load_torch_state_dict(save_path / POSE_CHECKPOINT_NAME), strict=True)
        self.optimizer.load_state_dict(blob["optimizer"])
        self.generator.set_state(blob["generator"])
        if "photo_generator" in blob:
            self.photo_generator.set_state(blob["photo_generator"])
        self.update.load_state_dict(blob)
        return {"epoch": int(blob["epoch"]), "best": float(blob["best"])}

    def fit(self) -> float:
        """Train ``cfg.epochs`` epochs (with ``cfg.resume``, from after the
        last checkpointed epoch of ``cfg.save_path``: the CSV logs append
        and the train loader's shuffle order carries on); returns the best
        validation metric: abs_rel against GT, else the photometric loss."""
        cfg = self.cfg
        save_path = Path(cfg.save_path)
        start_epoch, best = 0, math.inf
        if cfg.resume:
            last = self.restore(save_path)
            if last is not None and self.mesh.is_main:
                print(f"=> resumed after epoch {last['epoch']} (train step "
                      f"{self.update.micro_step}, best {last['best']:.4g})", flush=True)
            if last is not None:
                start_epoch, best = last["epoch"] + 1, last["best"]
        train_loader, val_loader = self.make_loaders()
        train_loader.epoch = start_epoch
        # rank 0 writes; the others log nowhere
        main = self.mesh.is_main
        logger = TermLogger(cfg.epochs, len(train_loader), len(val_loader), enabled=main)
        csv = CsvLogger(save_path, append=start_epoch > 0, enabled=main)
        jsonl = JsonlLogger(save_path / "metrics.jsonl", enabled=main)
        if self.tb is None:
            self.tb = make_tensorboard_writer(save_path) if main else NoopWriter()
        # best-model metric: abs_rel with GT, else the photometric val loss
        sel_key = "abs_rel" if self.val_with_gt else "photo_loss"
        try:
            for epoch in range(start_epoch, cfg.epochs):
                logger.epoch_start(epoch)
                train_loss = self.train_epoch(train_loader, logger, csv, jsonl)
                errors = self.validate(val_loader, logger)
                logger.print_result(
                    "val: " + ", ".join(f"{k}={v:.4f}" for k, v in errors.items()))
                jsonl.log(event="epoch", epoch=epoch, train_loss=train_loss,
                          lr=self.lr_schedule(self.step), **errors)
                csv.write_summary([train_loss, errors[sel_key]])
                self.tb.add_scalar("train/lr", self.lr_schedule(self.step), epoch)
                self.tb.add_scalar("train/loss", train_loss, epoch)
                for name, v in errors.items():
                    self.tb.add_scalar(f"val/{name}", v, epoch)
                is_best = errors[sel_key] < best
                best = min(best, errors[sel_key])
                self.save_checkpoint(save_path, epoch, is_best, best)
                if main:
                    (save_path / "trainer_meta.json").write_text(
                        json.dumps({"epoch": epoch, "best": best}))
        finally:
            jsonl.close()
            self.tb.close()
        return best
