"""Epoch-level training loop, the port of the supervised (regression and
depth-as-classification) and self-supervised paths of
``supervised_dispnet_tpu/training/trainer.py``:
per-epoch train pass, validation against GT depth (or, without GT, with the
self-supervised losses), CSV/JSONL logs, and checkpoints with a best-copy
when the validation metric improves.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from supervised_dispnet_tpu_torch.data.augment import AugmentConfig, normalize_images
from supervised_dispnet_tpu_torch.data.loader import BatchLoader
from supervised_dispnet_tpu_torch.data.packed import (
    PackedSequenceDataset, PackedValidationSet, is_packed)
from supervised_dispnet_tpu_torch.losses.classification import DepthBins, logits_to_depth
from supervised_dispnet_tpu_torch.training.train_step import (
    SUPERVISED_LOSSES, make_eval_step, make_selfsup_eval_step, make_selfsup_train_step,
    make_supervised_train_step)
from supervised_dispnet_tpu_torch.utils.device import resolve_device, set_fp32_math
from supervised_dispnet_tpu_torch.utils.logging import (
    AverageMeter, CsvLogger, JsonlLogger, TermLogger)

CHECKPOINT_NAME = "dispnet_checkpoint.pth.tar"
BEST_NAME = "dispnet_model_best.pth.tar"
POSE_CHECKPOINT_NAME = "exp_pose_checkpoint.pth.tar"
POSE_BEST_NAME = "exp_pose_model_best.pth.tar"


@dataclasses.dataclass
class TrainerConfig:
    """The supervised, classification and self-supervised fields of the JAX
    ``TrainerConfig``."""

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
    unless the caller passes ``device='cpu'``)."""

    def __init__(self, cfg: TrainerConfig, disp_model: torch.nn.Module,
                 pose_model: torch.nn.Module | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
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
        params = list(self.model.parameters())
        if self.selfsup:
            params += list(self.pose_model.parameters())
        self.optimizer = build_optimizer(cfg, params)
        self.lr_schedule = build_lr_schedule(cfg)
        self.aug = AugmentConfig()
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.step = 0  # optimizer updates taken
        self.val_with_gt = True  # set by make_loaders
        self.bins = DepthBins(num_bins=cfg.num_bins, max_depth=cfg.max_depth)
        self.eval_step = make_eval_step(self.model, classification=self.classification,
                                        bins=self.bins, max_depth=cfg.max_depth, aug=self.aug)
        if self.selfsup:
            self._train_step = make_selfsup_train_step(
                self.model, self.pose_model, self.optimizer,
                nb_ref_imgs=cfg.sequence_length - 1, photo_weight=cfg.photo_loss_weight,
                mask_weight=cfg.mask_loss_weight if cfg.with_exp_mask else 0.0,
                smooth_weight=cfg.smooth_loss_weight, rotation_mode=cfg.rotation_mode,
                padding_mode=cfg.padding_mode, aug=self.aug)
            self.selfsup_eval_step = make_selfsup_eval_step(
                self.model, self.pose_model, nb_ref_imgs=cfg.sequence_length - 1,
                rotation_mode=cfg.rotation_mode, padding_mode=cfg.padding_mode,
                with_exp=cfg.with_exp_mask and cfg.mask_loss_weight > 0, aug=self.aug)
        else:
            self._train_step = make_supervised_train_step(
                self.model, self.optimizer, cfg.loss, bins=self.bins, aug=self.aug,
                max_depth=cfg.max_depth)

    def to_device(self, np_batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in np_batch.items()}

    def prep_train_batch(self, np_batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """uint8 images, fp16 depth: half the depth bytes to the card; exact for
        the sparse zeros, < 0.05% relative below 80 m. Self-supervised
        batches carry the reference frames and no depth."""
        if self.selfsup:
            return self.to_device({k: np_batch[k] for k in ("tgt", "ref_imgs", "intrinsics")})
        return self.to_device({"tgt": np_batch["tgt"],
                               "intrinsics": np_batch["intrinsics"],
                               "depth": np_batch["depth"].astype(np.float16)})

    def train_step(self, batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """One optimizer update at the scheduled learning rate."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(self.step)
        metrics = self._train_step(batch, self.generator)
        self.step += 1
        return metrics

    @torch.no_grad()
    def predict(self, images) -> np.ndarray:
        """(B, H, W, 3) images in [0, 1] -> (B, H, W) finest-scale disparity;
        for the classification head, 1 / max(decoded depth, 1e-3)."""
        imgs = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        self.model.eval()
        out = self.model(normalize_images(imgs, self.aug.mean, self.aug.std))
        if self.classification:
            depth = logits_to_depth(out[0] if isinstance(out, list) else out, self.bins)
            disp = 1.0 / depth.clamp(min=1e-3)
        else:
            disp = out[0][..., 0]
        return disp.cpu().numpy()

    # -- data ---------------------------------------------------------------
    def make_loaders(self) -> tuple[BatchLoader, BatchLoader]:
        cfg = self.cfg
        if not is_packed(cfg.data):
            raise NotImplementedError(
                f"{cfg.data!r} is not a packed dataset: the port reads packed "
                "splits only (data/packed.py); JPEG dump trees: see ROADMAP.md")
        # supervised training never reads the reference frames
        train_set = PackedSequenceDataset(
            cfg.data, seed=cfg.seed, train=True,
            sequence_length=cfg.sequence_length if self.selfsup else 1,
            with_depth=not self.selfsup, uint8=True)
        try:
            val_set = PackedValidationSet(cfg.data, uint8=True)
        except FileNotFoundError:
            val_set = None
        self.val_with_gt = val_set is not None and len(val_set) >= cfg.batch_size
        if not self.val_with_gt:
            if not self.selfsup:
                raise RuntimeError(
                    "no packed val split with GT depth for a whole batch, and "
                    "not self-supervised: validation needs GT depth")
            # no GT depth: validate with the self-supervised losses
            val_set = PackedSequenceDataset(cfg.data, seed=cfg.seed, train=False,
                                            sequence_length=cfg.sequence_length,
                                            shuffle=False, uint8=True)
        train_loader = BatchLoader(train_set, cfg.batch_size, shuffle=True,
                                   seed=cfg.seed, epoch_size=cfg.epoch_size or None)
        val_loader = BatchLoader(val_set, cfg.batch_size, shuffle=False)
        return train_loader, val_loader

    # -- loops --------------------------------------------------------------
    def train_epoch(self, loader, logger: TermLogger, csv: CsvLogger,
                    jsonl: JsonlLogger) -> float:
        meter = AverageMeter(precision=4)
        t_data = AverageMeter(precision=3)
        t_batch = AverageMeter(precision=3)
        end = time.time()
        step0 = self.step

        def consume(i: int, metrics) -> None:
            # read one step late: step i's loss is read after step i+1 is
            # queued, so the host never leaves the card idle waiting on it
            loss = float(metrics["loss"])
            meter.update(loss)
            csv.write_iter([loss])
            logger.train_update(i, f"batch {t_batch} data {t_data} loss {meter}")
            jsonl.log(event="train_iter", step=step0 + i + 1, loss=loss)

        pending = None
        for i, np_batch in enumerate(loader):
            t_data.update(time.time() - end)
            metrics = self.train_step(self.prep_train_batch(np_batch))
            if pending is not None:
                consume(*pending)
            pending = (i, metrics)
            t_batch.update(time.time() - end)
            end = time.time()
        if pending is not None:
            consume(*pending)
        return meter.avg[0]

    def validate(self, loader, logger: TermLogger) -> dict[str, float]:
        """Validation against GT, or with the self-supervised losses when
        the val split has no GT; sums stay on the card, read back once."""
        sums: dict[str, torch.Tensor] = {}
        n = 0
        for i, np_batch in enumerate(loader):
            if self.val_with_gt:
                out = self.eval_step(self.to_device(
                    {"img": np_batch["img"], "depth": np_batch["depth"].astype(np.float16)}))
            else:
                out = self.selfsup_eval_step(self.to_device(
                    {k: np_batch[k] for k in ("tgt", "ref_imgs", "intrinsics")}))
            for k, v in out.items():
                sums[k] = sums[k] + v if k in sums else v
            n += 1
            logger.valid_update(i)
        return {k: float(v) / max(n, 1) for k, v in sums.items()}

    def save_checkpoint(self, save_path: Path, epoch: int, is_best: bool) -> None:
        """Disp model (``state_dict``, reference layout), optimizer,
        augmentation generator and step; the pose net's ``state_dict``
        beside it under the reference's name; each copied to its best file
        when ``is_best``."""
        path = save_path / CHECKPOINT_NAME
        torch.save({"epoch": epoch, "step": self.step,
                    "state_dict": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "generator": self.generator.get_state()}, path)
        if is_best:
            shutil.copyfile(path, save_path / BEST_NAME)
        if self.selfsup:
            pose_path = save_path / POSE_CHECKPOINT_NAME
            torch.save({"epoch": epoch, "state_dict": self.pose_model.state_dict()},
                       pose_path)
            if is_best:
                shutil.copyfile(pose_path, save_path / POSE_BEST_NAME)

    def fit(self) -> float:
        """Train ``cfg.epochs`` epochs; returns the best validation metric:
        abs_rel against GT, else the photometric loss."""
        cfg = self.cfg
        save_path = Path(cfg.save_path)
        train_loader, val_loader = self.make_loaders()
        logger = TermLogger(cfg.epochs, len(train_loader), len(val_loader))
        csv = CsvLogger(save_path)
        jsonl = JsonlLogger(save_path / "metrics.jsonl")
        best = float("inf")
        # best-model metric: abs_rel with GT, else the photometric val loss
        sel_key = "abs_rel" if self.val_with_gt else "photo_loss"
        try:
            for epoch in range(cfg.epochs):
                logger.epoch_start(epoch)
                train_loss = self.train_epoch(train_loader, logger, csv, jsonl)
                errors = self.validate(val_loader, logger)
                logger.print_result(
                    "val: " + ", ".join(f"{k}={v:.4f}" for k, v in errors.items()))
                jsonl.log(event="epoch", epoch=epoch, train_loss=train_loss,
                          lr=self.lr_schedule(self.step), **errors)
                csv.write_summary([train_loss, errors[sel_key]])
                is_best = errors[sel_key] < best
                best = min(best, errors[sel_key])
                self.save_checkpoint(save_path, epoch, is_best)
                (save_path / "trainer_meta.json").write_text(
                    json.dumps({"epoch": epoch, "best": best}))
        finally:
            jsonl.close()
        return best
