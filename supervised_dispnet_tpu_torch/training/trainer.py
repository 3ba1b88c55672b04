"""Epoch-level training driver, the port of the supervised path of
``supervised_dispnet_tpu/training/trainer.py``: per-epoch train pass,
validation against GT depth, CSV/JSONL logs, and a checkpoint with a
best-copy on abs_rel improvement.
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
from supervised_dispnet_tpu_torch.training.train_step import (
    SUPERVISED_LOSSES, make_eval_step, make_supervised_train_step)
from supervised_dispnet_tpu_torch.utils.device import resolve_device
from supervised_dispnet_tpu_torch.utils.logging import (
    AverageMeter, CsvLogger, JsonlLogger, TermLogger)

CHECKPOINT_NAME = "dispnet_checkpoint.pth.tar"
BEST_NAME = "dispnet_model_best.pth.tar"


@dataclasses.dataclass
class TrainerConfig:
    """The supervised fields of the JAX ``TrainerConfig``."""

    data: str = ""
    save_path: str = "checkpoints/exp"
    loss: str = "berhu"  # l1 | berhu | scale_invariant
    epochs: int = 200
    epoch_size: int = 0  # 0 = full epoch
    batch_size: int = 4
    lr: float = 2e-4
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0  # > 0: AdamW
    max_depth: float = 80.0
    seed: int = 0
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
    """Supervised training of ``disp_model`` on ``device`` (the card unless
    the caller passes ``device='cpu'``)."""

    def __init__(self, cfg: TrainerConfig, disp_model: torch.nn.Module,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if cfg.loss not in SUPERVISED_LOSSES:
            raise NotImplementedError(
                f"loss {cfg.loss!r} is not ported yet; see ROADMAP.md")
        self.cfg = cfg
        self.model = disp_model.to(self.device)
        self.optimizer = build_optimizer(cfg, self.model.parameters())
        self.lr_schedule = build_lr_schedule(cfg)
        self.aug = AugmentConfig()
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.step = 0  # optimizer updates taken
        self._train_step = make_supervised_train_step(
            self.model, self.optimizer, cfg.loss, aug=self.aug, max_depth=cfg.max_depth)
        self.eval_step = make_eval_step(self.model, max_depth=cfg.max_depth, aug=self.aug)

    def to_device(self, np_batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in np_batch.items()}

    def prep_train_batch(self, np_batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """uint8 images, fp16 depth: half the depth bytes to the card; exact for
        the sparse zeros, < 0.05% relative below 80 m."""
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
        """(B, H, W, 3) images in [0, 1] -> (B, H, W) finest-scale disparity."""
        imgs = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        self.model.eval()
        disp = self.model(normalize_images(imgs, self.aug.mean, self.aug.std))[0]
        return disp[..., 0].cpu().numpy()

    # -- data ---------------------------------------------------------------
    def make_loaders(self) -> tuple[BatchLoader, BatchLoader]:
        cfg = self.cfg
        if not is_packed(cfg.data):
            raise NotImplementedError(
                f"{cfg.data!r} is not a packed dataset: the port reads packed "
                "splits only (data/packed.py); JPEG dump trees: see ROADMAP.md")
        train_set = PackedSequenceDataset(cfg.data, seed=cfg.seed, train=True,
                                          sequence_length=1, with_depth=True,
                                          uint8=True)
        try:
            val_set = PackedValidationSet(cfg.data, uint8=True)
        except FileNotFoundError:
            val_set = None
        if val_set is None or len(val_set) < cfg.batch_size:
            raise RuntimeError(
                "no packed val split with GT depth for a whole batch: "
                "validation without GT (self-supervised losses) is not "
                "ported yet; see ROADMAP.md")
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
        """Validation against GT; sums stay on the card, read back once."""
        sums: dict[str, torch.Tensor] = {}
        n = 0
        for i, np_batch in enumerate(loader):
            batch = self.to_device({"img": np_batch["img"],
                                    "depth": np_batch["depth"].astype(np.float16)})
            for k, v in self.eval_step(batch).items():
                sums[k] = sums[k] + v if k in sums else v
            n += 1
            logger.valid_update(i)
        return {k: float(v) / max(n, 1) for k, v in sums.items()}

    def save_checkpoint(self, save_path: Path, epoch: int, is_best: bool) -> None:
        """Model (``state_dict``, reference layout), optimizer, augmentation
        generator and step; copied to the best file when ``is_best``."""
        path = save_path / CHECKPOINT_NAME
        torch.save({"epoch": epoch, "step": self.step,
                    "state_dict": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "generator": self.generator.get_state()}, path)
        if is_best:
            shutil.copyfile(path, save_path / BEST_NAME)

    def fit(self) -> float:
        """Train ``cfg.epochs`` epochs; returns the best val abs_rel."""
        cfg = self.cfg
        save_path = Path(cfg.save_path)
        train_loader, val_loader = self.make_loaders()
        logger = TermLogger(cfg.epochs, len(train_loader), len(val_loader))
        csv = CsvLogger(save_path)
        jsonl = JsonlLogger(save_path / "metrics.jsonl")
        best = float("inf")
        try:
            for epoch in range(cfg.epochs):
                logger.epoch_start(epoch)
                train_loss = self.train_epoch(train_loader, logger, csv, jsonl)
                errors = self.validate(val_loader, logger)
                logger.print_result(
                    "val: " + ", ".join(f"{k}={v:.4f}" for k, v in errors.items()))
                jsonl.log(event="epoch", epoch=epoch, train_loss=train_loss,
                          lr=self.lr_schedule(self.step), **errors)
                csv.write_summary([train_loss, errors["abs_rel"]])
                is_best = errors["abs_rel"] < best
                best = min(best, errors["abs_rel"])
                self.save_checkpoint(save_path, epoch, is_best)
                (save_path / "trainer_meta.json").write_text(
                    json.dumps({"epoch": epoch, "best": best}))
        finally:
            jsonl.close()
        return best
