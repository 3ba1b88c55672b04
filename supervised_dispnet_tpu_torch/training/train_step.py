"""Train and eval steps, the port of
``supervised_dispnet_tpu/training/train_step.py``
(``make_supervised_train_step``, ``make_selfsup_train_step``,
``make_selfsup_eval_step``, ``make_eval_step``).

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
from supervised_dispnet_tpu_torch.losses.classification import (
    DepthBins, depth_classification_loss, logits_to_depth, multiscale_classification_loss)
from supervised_dispnet_tpu_torch.losses.metrics import compute_errors
from supervised_dispnet_tpu_torch.losses.selfsup import (
    explainability_loss, photometric_reconstruction_loss, smooth_loss)
from supervised_dispnet_tpu_torch.losses.supervised import (
    berhu_loss, l1_loss, multiscale_supervised_loss, scale_invariant_loss)

SUPERVISED_LOSSES: dict[str, Callable] = {
    "l1": l1_loss,
    "berhu": berhu_loss,
    "scale_invariant": scale_invariant_loss,
}
# the CE of loss_name="classification", read when a step is built: the CUDA
# kernels on the card, the plain version on the CPU
CLASSIFICATION_CE: Callable = depth_classification_loss


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
    bins: DepthBins | None = None,
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
    ``loss_name='classification'`` trains the bin-logit head against
    ``bins.depth_to_index`` of the GT (``bins`` defaults to ``DepthBins()``):
    the CE of the (B, H, W, K) logits, or the weighted CE of the four scales
    when the model returns a list. BerHu and the CE on the card run the CUDA
    kernels, on the CPU their plain versions.
    """
    _not_ported(ema_decay=ema_decay, accum_steps=accum_steps > 1,
                fake_quant=fake_quant, mesh=mesh)
    classification = loss_name == "classification"
    if not classification and loss_name not in SUPERVISED_LOSSES:
        raise ValueError(f"unknown supervised loss {loss_name!r}; choices: "
                         f"{sorted(SUPERVISED_LOSSES)} and 'classification'")
    bins = bins or DepthBins()
    loss_fn = SUPERVISED_LOSSES.get(loss_name)
    ce_fn = CLASSIFICATION_CE

    def compute_loss(out, depth_gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if not classification:
            return multiscale_supervised_loss(disps_to_depths(out), depth_gt, mask, loss_fn)
        if isinstance(out, list):
            return multiscale_classification_loss(out, depth_gt, mask, bins, ce_fn=ce_fn)
        return ce_fn(out, depth_gt, mask, bins)

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
        loss = compute_loss(model(imgs[:, 0]), depth_gt, mask)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return step


def make_selfsup_train_step(
    disp_model: torch.nn.Module,
    pose_model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    nb_ref_imgs: int = 2,
    photo_weight: float = 1.0,
    mask_weight: float = 0.2,
    smooth_weight: float = 0.1,
    rotation_mode: str = "euler",
    padding_mode: str = "zeros",
    aug: AugmentConfig = AugmentConfig(),
    num_scales: int = 4,
):
    """Build the self-supervised step (photometric + explainability +
    smoothness, BASELINE config 5): ``step(batch, generator=None,
    draws=None) -> {"loss", "photo_loss", "exp_loss", "smooth_loss"}``, 0-d
    tensors on the device. ``optimizer`` holds both nets' parameters, as the
    JAX step applies one optax transform to ``{"disp", "pose"}``; both nets
    are updated in place. ``mask_weight == 0`` drops the explainability term
    (and the pose net's masks).

    batch: {'tgt': (B, H, W, 3), 'ref_imgs': (B, R, H, W, 3), uint8 or
    [0, 1] float; 'intrinsics': (B, 3, 3)}, on the models' device. The warps
    run the CUDA kernels on the card and the plain sampler on the CPU. The
    JAX step's other options (half-res, stochastic and remat photometric
    terms, EMA, accumulation, QAT, a mesh) are not ported; see ROADMAP.md.
    """
    with_exp = mask_weight > 0

    def step(batch: dict, generator: torch.Generator | None = None,
             draws: dict | None = None) -> dict[str, torch.Tensor]:
        snippet = torch.cat([imgs_to_float(batch["tgt"])[:, None],
                             imgs_to_float(batch["ref_imgs"])], dim=1)
        imgs, K = augment_batch(snippet, batch["intrinsics"], config=aug,
                                generator=generator, draws=draws)
        tgt = imgs[:, 0]
        refs = [imgs[:, 1 + r] for r in range(nb_ref_imgs)]
        disp_model.train()
        pose_model.train()
        optimizer.zero_grad(set_to_none=True)
        disps = disp_model(tgt)[:num_scales]
        exp_masks, pose = pose_model(tgt, refs)
        exp_masks = exp_masks[:num_scales] if with_exp else None
        photo, _ = photometric_reconstruction_loss(
            tgt, refs, K, disps_to_depths(disps), exp_masks, pose,
            rotation_mode=rotation_mode, padding_mode=padding_mode)
        exp_l = (explainability_loss(exp_masks) if with_exp
                 else torch.zeros((), dtype=torch.float32, device=tgt.device))
        smooth = smooth_loss(disps)
        loss = photo_weight * photo + mask_weight * exp_l + smooth_weight * smooth
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "photo_loss": photo.detach(),
                "exp_loss": exp_l.detach(), "smooth_loss": smooth.detach()}

    return step


def make_selfsup_eval_step(
    disp_model: torch.nn.Module,
    pose_model: torch.nn.Module,
    nb_ref_imgs: int = 2,
    rotation_mode: str = "euler",
    padding_mode: str = "zeros",
    num_scales: int = 4,
    with_exp: bool = True,
    aug: AugmentConfig | None = None,
):
    """Loss-only self-supervised validation (the reference's
    ``validate_without_gt``): ``step(batch) -> {"photo_loss", "exp_loss",
    "smooth_loss"}``, 0-d tensors on the device, no gradients.

    batch: {'tgt', 'ref_imgs', 'intrinsics'}. With ``aug`` set, images arrive
    raw (uint8 or [0, 1] float) and are normalised here.
    """

    def prep(x: torch.Tensor) -> torch.Tensor:
        x = imgs_to_float(x)
        return normalize_images(x, aug.mean, aug.std) if aug is not None else x

    @torch.no_grad()
    def step(batch: dict) -> dict[str, torch.Tensor]:
        tgt = prep(batch["tgt"])
        refs = [prep(batch["ref_imgs"][:, r]) for r in range(nb_ref_imgs)]
        disp_model.eval()
        pose_model.eval()
        disps = disp_model(tgt)[:num_scales]
        exp_masks, pose = pose_model(tgt, refs)
        exp_masks = exp_masks[:num_scales] if with_exp else None
        photo, _ = photometric_reconstruction_loss(
            tgt, refs, batch["intrinsics"], disps_to_depths(disps), exp_masks, pose,
            rotation_mode=rotation_mode, padding_mode=padding_mode)
        exp_l = (explainability_loss(exp_masks) if with_exp
                 else torch.zeros((), dtype=torch.float32, device=tgt.device))
        return {"photo_loss": photo, "exp_loss": exp_l, "smooth_loss": smooth_loss(disps)}

    return step


def make_eval_step(model: torch.nn.Module, classification: bool = False,
                   bins: DepthBins | None = None, max_depth: float = 80.0,
                   aug: AugmentConfig | None = None):
    """Validation step: forward + Eigen metrics against GT.
    ``step(batch) -> dict of 0-d tensors on the device``. With
    ``classification``, the depth is the finest logits' soft decode
    (``logits_to_depth`` over ``bins``, default ``DepthBins()``); no CE runs.

    batch: {'img': (B, H, W, 3), 'depth': (B, H, W)}. With ``aug`` set,
    images arrive raw (uint8 or [0, 1] float) and are normalised here;
    depth may arrive fp16 and is evaluated in fp32.
    """
    bins = bins or DepthBins()

    @torch.no_grad()
    def step(batch: dict) -> dict[str, torch.Tensor]:
        img = imgs_to_float(batch["img"])
        if aug is not None:
            img = normalize_images(img, aug.mean, aug.std)
        model.eval()
        out = model(img)
        if classification:
            depth = logits_to_depth(out[0] if isinstance(out, list) else out, bins)
        else:
            depth = 1.0 / out[0][..., 0]
        gt = depth_to_float(batch["depth"])
        return compute_errors(gt, depth, (gt > 0) & (gt < max_depth))

    return step
