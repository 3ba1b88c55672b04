"""Train and eval steps, the port of
``supervised_dispnet_tpu/training/train_step.py``
(``make_supervised_train_step``, ``make_selfsup_train_step``,
``make_selfsup_eval_step``, ``make_eval_step``).

The JAX step is one pure jitted function of (state, batch); here the model
and optimizer hold the state and are updated in place, and PyTorch runs
eagerly. A step's metrics stay on the device, so nothing waits for the card
inside the step (unless ``debug_nans`` asks it to). What the JAX
``TrainState.apply_gradients`` adds to the optimizer, gradient accumulation
and the EMA shadow, is ``ApplyGradients``; each train step carries its own
as ``step.update``.
"""

from __future__ import annotations

import contextlib
from collections.abc import Callable, Iterable

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


def output_depth(out, bins: DepthBins | None = None) -> torch.Tensor:
    """(B, H, W) depth of a network's output: the soft decode of the finest
    bin logits over ``bins`` (classification), 1 / the finest disparity
    (a list of disparity maps), or the map itself (FCRN's one (B, H, W, 1)
    tensor of depth)."""
    if bins is not None:
        return logits_to_depth(out[0] if isinstance(out, list) else out, bins)
    if isinstance(out, list):
        return 1.0 / out[0][..., 0]
    return out[..., 0]


def _not_ported(**options) -> None:
    for name, value in options.items():
        if value:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet; see ROADMAP.md")


class ApplyGradients:
    """The JAX ``TrainState.apply_gradients`` for models updated in place:
    called after each backward (a micro-step), it

    - with ``debug_nans``, raises ``FloatingPointError`` naming the step
      when the loss or a gradient is not finite, before anything changes;
    - with ``accum_steps`` k > 1, folds the gradients into their running
      mean, as ``optax.MultiSteps`` does (acc += (g - acc) / (n + 1)), and
      applies it as one optimizer update every k-th micro-step; a partial
      accumulation carries over to the next micro-steps;
    - after each optimizer update, with ``ema_decay`` d > 0, blends the
      parameters into their shadow, ema = d * ema + (1 - d) * params (not
      the BatchNorm buffers).

    ``micro_step`` counts micro-steps (the JAX ``state.step``), ``updates``
    the optimizer updates. ``state_dict`` / ``load_state_dict`` carry all of
    it, partial accumulation included, for an exact resume."""

    def __init__(self, named_params: Iterable[tuple[str, torch.nn.Parameter]],
                 optimizer: torch.optim.Optimizer, ema_decay: float = 0.0,
                 accum_steps: int = 1, debug_nans: bool = False):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if not 0.0 <= ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.optimizer = optimizer
        self.ema_decay = ema_decay
        self.accum_steps = accum_steps
        self.debug_nans = debug_nans
        self.micro_step = 0
        self._acc: list[torch.Tensor] | None = None
        self.ema = ([p.detach().clone() for p in self.params] if ema_decay > 0
                    else None)

    @property
    def updates(self) -> int:
        return self.micro_step // self.accum_steps

    def __call__(self, loss: torch.Tensor) -> None:
        if self.debug_nans:
            self._check_finite(loss)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        mini = self.micro_step % self.accum_steps
        self.micro_step += 1
        if self.accum_steps > 1:
            if mini == 0:
                self._acc = [g.detach() for g in grads]
            else:
                diff = torch._foreach_sub(grads, self._acc)
                torch._foreach_div_(diff, float(mini + 1))
                torch._foreach_add_(self._acc, diff)
            if mini + 1 < self.accum_steps:
                return
            for p, g in zip(self.params, self._acc):
                p.grad = g
            self._acc = None
        self.optimizer.step()
        if self.ema is not None:
            with torch.no_grad():
                torch._foreach_mul_(self.ema, self.ema_decay)
                torch._foreach_add_(self.ema, self.params, alpha=1.0 - self.ema_decay)

    def _check_finite(self, loss: torch.Tensor) -> None:
        """One read of the card: the loss's and each gradient's finiteness."""
        grads = [(n, p.grad) for n, p in zip(self.names, self.params) if p.grad is not None]
        ok = torch.stack([torch.isfinite(loss.detach()).all()]
                         + [torch.isfinite(g).all() for _, g in grads]).cpu()
        if not bool(ok.all()):
            what = (["loss"] if not ok[0] else []) + [
                n for (n, _), good in zip(grads, ok[1:].tolist()) if not good]
            raise FloatingPointError(
                f"non-finite {', '.join(what[:4])}"
                f"{' ...' if len(what) > 4 else ''} at train step {self.micro_step} "
                f"(update {self.updates}); no update was applied")

    @contextlib.contextmanager
    def ema_params(self):
        """The parameters hold the EMA shadow inside the block (validation
        and inference, as the JAX trainer's ``eval_params``); the live
        values outside it. A no-op without EMA."""
        if self.ema is None:
            yield
            return
        live = [p.data for p in self.params]
        for p, e in zip(self.params, self.ema):
            p.data = e
        try:
            yield
        finally:
            for p, d in zip(self.params, live):
                p.data = d

    def state_dict(self) -> dict:
        return {"micro_step": self.micro_step,
                "ema": None if self.ema is None else dict(zip(self.names, self.ema)),
                "acc": None if self._acc is None else dict(zip(self.names, self._acc))}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict``'s values (tensors copied in place). A state
        without an EMA shadow (a run without EMA) re-seeds the shadow from
        the current parameters, as the JAX restore does."""
        self.micro_step = int(state["micro_step"])
        if self.ema is not None:
            saved = state.get("ema")
            with torch.no_grad():
                for n, e, p in zip(self.names, self.ema, self.params):
                    e.copy_(saved[n] if saved is not None else p)
        acc = state.get("acc")
        self._acc = (None if acc is None else
                     [acc[n].to(p.device, p.dtype) for n, p in zip(self.names, self.params)])


def make_supervised_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_name: str = "berhu",
    bins: DepthBins | None = None,
    aug: AugmentConfig = AugmentConfig(),
    max_depth: float = 80.0,
    ema_decay: float = 0.0,
    accum_steps: int = 1,
    debug_nans: bool = False,
    fake_quant: bool = False,
    mesh=None,
):
    """Build the supervised step: ``step(batch, generator=None, draws=None)
    -> {"loss": 0-d tensor on the device}``, one micro-step; it updates
    ``model`` and ``optimizer`` in place and leaves the gradients in
    ``.grad``. ``ema_decay``, ``accum_steps`` and ``debug_nans`` are
    ``ApplyGradients``'s, which the step carries as ``step.update``.

    batch: {'tgt': (B, H, W, 3) uint8 or [0, 1] float, 'intrinsics':
    (B, 3, 3), 'depth': (B, H, W) sparse GT, fp16 or fp32}, on the model's
    device. ``generator`` draws the augmentation (on the batch's device);
    ``draws`` gives its random numbers instead (``data/augment.py``).
    ``loss_name='classification'`` trains the bin-logit head against
    ``bins.depth_to_index`` of the GT (``bins`` defaults to ``DepthBins()``):
    the CE of the (B, H, W, K) logits, or the weighted CE of the four scales
    when the model returns a list. A model that returns one (B, H, W, 1)
    tensor (FCRN) predicts depth, and the loss takes it at its one scale.
    BerHu and the CE on the card run the CUDA kernels, on the CPU their
    plain versions.
    """
    _not_ported(fake_quant=fake_quant, mesh=mesh)
    classification = loss_name == "classification"
    if not classification and loss_name not in SUPERVISED_LOSSES:
        raise ValueError(f"unknown supervised loss {loss_name!r}; choices: "
                         f"{sorted(SUPERVISED_LOSSES)} and 'classification'")
    bins = bins or DepthBins()
    loss_fn = SUPERVISED_LOSSES.get(loss_name)
    ce_fn = CLASSIFICATION_CE
    update = ApplyGradients(model.named_parameters(), optimizer, ema_decay, accum_steps,
                            debug_nans)

    def compute_loss(out, depth_gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if not classification:
            if not isinstance(out, list):
                # FCRN: one map of metric depth (Laina et al. train it with
                # BerHu on depth); on the card a grouped BerHu of one problem
                return loss_fn(out[..., 0], depth_gt, mask)
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
        update(loss)
        return {"loss": loss.detach()}

    step.update = update
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
    ema_decay: float = 0.0,
    accum_steps: int = 1,
    debug_nans: bool = False,
    remat_photo: bool = False,
    half_res_photo: bool = False,
    batch_refs: bool = False,
    stochastic_photo: int = 1,
    photo_generator: torch.Generator | None = None,
    fake_quant: bool = False,
):
    """Build the self-supervised step (photometric + explainability +
    smoothness, BASELINE config 5): ``step(batch, generator=None,
    draws=None) -> {"loss", "photo_loss", "exp_loss", "smooth_loss"}``, 0-d
    tensors on the device, one micro-step. ``optimizer`` holds both nets'
    parameters, as the JAX step applies one optax transform to ``{"disp",
    "pose"}``; both nets are updated in place, through ``step.update``
    (``ApplyGradients``: ``ema_decay``, ``accum_steps``, ``debug_nans``;
    parameter names ``disp.*`` and ``pose.*``). ``mask_weight == 0`` drops
    the explainability term (and the pose net's masks). ``remat_photo``
    checkpoints the photometric terms (``--remat``); ``half_res_photo``,
    ``batch_refs`` and ``stochastic_photo`` N > 1 pick the photometric
    loss's arms (``losses/selfsup.py``). The stochastic arm's phases are
    drawn on the host from ``photo_generator``, a CPU generator (a seed-0 one
    by default), as the JAX step draws them from its ``photo_key``;
    ``step(..., photo_phases=((oy, ox),) * 4)`` fixes them.

    batch: {'tgt': (B, H, W, 3), 'ref_imgs': (B, R, H, W, 3), uint8 or
    [0, 1] float; 'intrinsics': (B, 3, 3)}, on the models' device. The warps
    run the CUDA kernels on the card and the plain sampler on the CPU. QAT
    (``fake_quant``) is not ported and raises; see ROADMAP.md.
    """
    _not_ported(fake_quant=fake_quant)
    if photo_generator is None:
        photo_generator = torch.Generator().manual_seed(0)
    with_exp = mask_weight > 0
    named = [(f"{tag}.{n}", p) for tag, net in (("disp", disp_model), ("pose", pose_model))
             for n, p in net.named_parameters()]
    update = ApplyGradients(named, optimizer, ema_decay, accum_steps, debug_nans)

    def step(batch: dict, generator: torch.Generator | None = None,
             draws: dict | None = None,
             photo_phases: tuple | None = None) -> dict[str, torch.Tensor]:
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
            rotation_mode=rotation_mode, padding_mode=padding_mode, remat=remat_photo,
            half_res=half_res_photo, batch_refs=batch_refs,
            stochastic_stride=stochastic_photo, generator=photo_generator,
            stochastic_phases=photo_phases)
        exp_l = (explainability_loss(exp_masks) if with_exp
                 else torch.zeros((), dtype=torch.float32, device=tgt.device))
        smooth = smooth_loss(disps)
        loss = photo_weight * photo + mask_weight * exp_l + smooth_weight * smooth
        loss.backward()
        update(loss)
        return {"loss": loss.detach(), "photo_loss": photo.detach(),
                "exp_loss": exp_l.detach(), "smooth_loss": smooth.detach()}

    step.update = update
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
        depth = output_depth(out, bins if classification else None)
        gt = depth_to_float(batch["depth"])
        return compute_errors(gt, depth, (gt > 0) & (gt < max_depth))

    return step
