"""Supervised train step and eval step, the port of
``supervised_dispnet_tpu/training/train_step.py``
(``make_supervised_train_step``, ``make_eval_step``).

The JAX step is one pure jitted function of (state, batch); here the model
and optimizer hold the state and are updated in place, and PyTorch runs
eagerly. A step's metrics stay on the device, so nothing waits for the card
inside the step.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from supervised_dispnet_tpu_torch.data.augment import (
    AugmentConfig, augment_batch, normalize_images)
from supervised_dispnet_tpu_torch.losses.metrics import compute_errors
from supervised_dispnet_tpu_torch.losses.supervised import (
    berhu_loss, l1_loss, multiscale_supervised_loss, scale_invariant_loss)

SUPERVISED_LOSSES: dict[str, Callable] = {
    "l1": l1_loss,
    "berhu": berhu_loss,
    "scale_invariant": scale_invariant_loss,
}


def imgs_to_float(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1] on the device (no-op for floats).
    Batches travel to the card as uint8, a quarter of the bytes."""
    return x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 else x


def depth_to_float(x: torch.Tensor) -> torch.Tensor:
    """fp16-transported GT depth -> float32 (exact for the sparse zeros,
    < 0.05% relative below the 80 m cap)."""
    return x.to(torch.float32)


def disps_to_depths(disps: list[torch.Tensor]) -> list[torch.Tensor]:
    """disparity (B, h, w, 1) -> depth (B, h, w) = 1 / disp."""
    return [1.0 / d[..., 0] for d in disps]


def _not_ported(**options) -> None:
    for name, value in options.items():
        if value:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet; see ROADMAP.md")


def make_supervised_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_name: str = "berhu",
    aug: AugmentConfig = AugmentConfig(),
    max_depth: float = 80.0,
    ema_decay: float = 0.0,
    accum_steps: int = 1,
    fake_quant: bool = False,
    mesh=None,
):
    """Build the supervised step: ``step(batch, generator=None, draws=None)
    -> {"loss": 0-d tensor on the device}``; it updates ``model`` and
    ``optimizer`` in place and leaves the gradients in ``.grad``.

    batch: {'tgt': (B, H, W, 3) uint8 or [0, 1] float, 'intrinsics':
    (B, 3, 3), 'depth': (B, H, W) sparse GT, fp16 or fp32}, on the model's
    device. ``generator`` draws the augmentation (on the batch's device);
    ``draws`` gives its random numbers instead (``data/augment.py``).
    BerHu on the card runs the CUDA kernel, on the CPU its plain version.
    """
    _not_ported(ema_decay=ema_decay, accum_steps=accum_steps > 1,
                fake_quant=fake_quant, mesh=mesh)
    if loss_name not in SUPERVISED_LOSSES:
        raise NotImplementedError(
            f"supervised loss {loss_name!r} is not ported; ported: "
            f"{sorted(SUPERVISED_LOSSES)} (classification: see ROADMAP.md)")
    loss_fn = SUPERVISED_LOSSES[loss_name]

    def step(batch: dict, generator: torch.Generator | None = None,
             draws: dict | None = None) -> dict[str, torch.Tensor]:
        imgs, _, depth_gt = augment_batch(
            imgs_to_float(batch["tgt"])[:, None], batch["intrinsics"],
            depth_to_float(batch["depth"]), config=aug, generator=generator,
            draws=draws)
        depth_gt = depth_gt.contiguous()
        mask = (depth_gt > 0) & (depth_gt < max_depth)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        depths = disps_to_depths(model(imgs[:, 0]))
        loss = multiscale_supervised_loss(depths, depth_gt, mask, loss_fn)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return step


def make_eval_step(model: torch.nn.Module, classification: bool = False,
                   max_depth: float = 80.0, aug: AugmentConfig | None = None):
    """Validation step: forward + Eigen metrics against GT.
    ``step(batch) -> dict of 0-d tensors on the device``.

    batch: {'img': (B, H, W, 3), 'depth': (B, H, W)}. With ``aug`` set,
    images arrive raw (uint8 or [0, 1] float) and are normalised here;
    depth may arrive fp16 and is evaluated in fp32.
    """
    _not_ported(classification=classification)

    @torch.no_grad()
    def step(batch: dict) -> dict[str, torch.Tensor]:
        img = imgs_to_float(batch["img"])
        if aug is not None:
            img = normalize_images(img, aug.mean, aug.std)
        model.eval()
        depth = 1.0 / model(img)[0][..., 0]
        gt = depth_to_float(batch["depth"])
        return compute_errors(gt, depth, (gt > 0) & (gt < max_depth))

    return step
