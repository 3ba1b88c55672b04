"""Self-supervised losses: multi-scale photometric inverse-warp L1,
explainability and second-order smoothness. The port of
``supervised_dispnet_tpu/losses/selfsup.py``, with its arms: the default
(one inverse warp per reference frame and scale, at full resolution),
``half_res``, ``batch_refs`` and ``stochastic_stride``.

The image pyramid is 2x2 average pooling, intrinsics are rescaled per scale,
and each term is a mean over all pixels with out-of-view differences zeroed,
as in the reference. The photometric loss samples every warp of a step with
one ``ops.warp.sample_many`` call, whatever the arm: on the card, one
grouped kernel launch each way a step (with ``remat``, one more forward
launch when the backward recomputes the terms). The arms change only the
problems in that call: ``half_res`` gives the same 4 x R problems at a
quarter of the pixels, ``batch_refs`` one problem of batch R * B a scale,
``stochastic_stride`` s the 4 x R problems with an output grid of 1/s^2 of
the source image's pixels.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from supervised_dispnet_tpu_torch.models.common import remat_call
from supervised_dispnet_tpu_torch.ops import warp
from supervised_dispnet_tpu_torch.ops.resize import downsample2x_avg


def _scale_intrinsics(intrinsics: torch.Tensor, factor: float) -> torch.Tensor:
    """Scale fx, fy, cx, cy by ``factor`` (a downsampled image plane)."""
    scale = torch.tensor([[factor, 1.0, factor], [1.0, factor, factor], [1.0, 1.0, 1.0]],
                         dtype=intrinsics.dtype, device=intrinsics.device)
    return intrinsics * scale


def _phase_subsample(x: torch.Tensor, s: int, oy: int, ox: int) -> torch.Tensor:
    """Every s-th pixel of x (B, H, W[, C]) from phase (oy, ox): (B, H/s,
    W/s[, C]), a view. H and W must be multiples of s."""
    B, H, W = x.shape[:3]
    if H % s or W % s:
        raise ValueError(f"stochastic_stride {s} must divide every scale's spatial dims; "
                         f"got ({H}, {W})")
    return x.reshape(B, H // s, s, W // s, s, *x.shape[3:])[:, :, oy, :, ox]


def _subsample_intrinsics(K: torch.Tensor, s: int, oy: int, ox: int) -> torch.Tensor:
    """K' = A^-1 K for the grid map x_full = s * x_sub + ox: back-projecting
    sub-grid pixel (i, j) through K' is back-projecting its full-resolution
    pixel (s * i + oy, s * j + ox) through K."""
    fx, fy, cx, cy, skew = K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2], K[:, 0, 1]
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx / s, skew / s, (cx - ox) / s], dim=-1),
                        torch.stack([zeros, fy / s, (cy - oy) / s], dim=-1),
                        torch.stack([zeros, zeros, ones], dim=-1)], dim=1)


def draw_phases(stride: int, num_scales: int,
                generator: torch.Generator) -> tuple[tuple[int, int], ...]:
    """Per-scale (oy, ox) phases in [0, stride), drawn on the host from the
    CPU ``generator``: the step reads nothing back from the card for them."""
    draws = torch.randint(0, stride, (num_scales, 2), generator=generator).tolist()
    return tuple((oy, ox) for oy, ox in draws)


def photometric_reconstruction_loss(
    tgt_img: torch.Tensor,
    ref_imgs: Sequence[torch.Tensor],
    intrinsics: torch.Tensor,
    depths: Sequence[torch.Tensor],
    explainability_masks: Sequence[torch.Tensor] | None,
    pose: torch.Tensor,
    rotation_mode: str = "euler",
    padding_mode: str = "zeros",
    half_res: bool = False,
    remat: bool = False,
    batch_refs: bool = False,
    stochastic_stride: int = 1,
    generator: torch.Generator | None = None,
    stochastic_phases: Sequence[tuple[int, int]] | None = None,
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Sum over scales and reference frames of the mean |tgt - warped ref|,
    with out-of-view pixels zeroed and, when given, weighted by the
    explainability mask.

    tgt_img and each of ref_imgs: (B, H, W, 3); intrinsics (B, 3, 3) at full
    resolution; depths: per-scale target depths (B, H/2^s, W/2^s), finest
    first; explainability_masks: per-scale (B, h, w, R) or None; pose
    (B, R, 6) target->ref. The refs are data: their warps form coordinate
    gradients only. All warps are sampled together (``ops.warp.
    sample_many``), then the terms are summed scale-major, ref-minor.
    Returns (loss, the finest scale's warped refs).

    - ``half_res``: the whole pyramid one octave down (images and masks by
      ``downsample2x_avg``, depths by their 2x2 mean).
    - ``batch_refs``: a scale's R refs as one warp of batch R * B (depth,
      pose, intrinsics and target repeated); its term is R times the mean
      over the concatenated batch, the same sum.
    - ``stochastic_stride`` s > 1: each scale's term at every s-th target
      pixel per axis from a phase (oy, ox), back-projected through
      phase-adjusted intrinsics: an unbiased estimate of the full term (the
      mean over all s^2 phases is the full loss). The phases are
      ``stochastic_phases`` when given, else drawn per scale from the CPU
      ``generator`` (``draw_phases``). Not with ``batch_refs``.
    - ``remat`` checkpoints the terms (pyramid, projections, warps and
      differences): the backward recomputes them instead of holding them, and
      the warped refs come back empty, as the JAX package's remat arm does.
    """
    phases = None
    if stochastic_stride > 1:
        if batch_refs:
            raise ValueError("stochastic_stride > 1 is only supported with the per-ref "
                             "arm (batch_refs=False)")
        if generator is None and stochastic_phases is None:
            raise ValueError("stochastic_stride > 1 needs a generator (or explicit "
                             "stochastic_phases)")
        # drawn outside the terms, so that a remat recompute sees the same
        phases = (tuple(stochastic_phases) if stochastic_phases is not None
                  else draw_phases(stochastic_stride, len(depths), generator))
    args = (tgt_img, ref_imgs, intrinsics, depths, explainability_masks, pose,
            rotation_mode, padding_mode, half_res, batch_refs, stochastic_stride, phases)
    if remat:
        return remat_call("full", lambda: _photometric_terms(*args)[0]), []
    return _photometric_terms(*args)


def _photometric_terms(tgt_img, ref_imgs, intrinsics, depths, explainability_masks, pose,
                       rotation_mode, padding_mode, half_res, batch_refs, stride,
                       phases) -> tuple[torch.Tensor, list[torch.Tensor]]:
    masks = explainability_masks
    tgt_s, refs_s = tgt_img, list(ref_imgs)
    scale0 = 1.0
    if half_res:
        tgt_s = downsample2x_avg(tgt_s)
        refs_s = [downsample2x_avg(r) for r in refs_s]
        depths = [d.reshape(d.shape[0], d.shape[1] // 2, 2, d.shape[2] // 2, 2).mean(dim=(2, 4))
                  for d in depths]
        if masks is not None:
            masks = [downsample2x_avg(m) for m in masks]
        scale0 = 0.5
    R, B = len(refs_s), tgt_img.shape[0]
    # one entry a sampling problem: (scale, target, mask or None, factor)
    terms, imgs, xs, ys, valids = [], [], [], [], []

    def add(s, img, coords, tgt, mask, factor=1):
        x, y, valid = coords
        terms.append((s, tgt, mask, factor))
        imgs.append(img)
        xs.append(x)
        ys.append(y)
        valids.append(valid)

    for s, depth in enumerate(depths):
        if s > 0:
            tgt_s = downsample2x_avg(tgt_s)
            refs_s = [downsample2x_avg(r) for r in refs_s]
        K_s = _scale_intrinsics(intrinsics, scale0 / 2 ** s)
        if batch_refs:
            refs_cat = torch.cat(refs_s, dim=0)
            coords = warp.warp_coords(torch.cat([depth] * R), torch.cat(list(pose.unbind(1))),
                                      torch.cat([K_s] * R), refs_cat.shape[1:3],
                                      rotation_mode)
            mask = None
            if masks is not None:
                m = masks[s]
                mask = m.movedim(-1, 0).reshape(R * B, *m.shape[1:3], 1)
            add(s, refs_cat, coords, torch.cat([tgt_s] * R), mask, R)
            continue
        tgt_t, depth_t, K_t = tgt_s, depth, None
        if stride > 1:
            oy, ox = phases[s]
            tgt_t = _phase_subsample(tgt_s, stride, oy, ox)
            depth_t = _phase_subsample(depth, stride, oy, ox)
            K_t = _subsample_intrinsics(K_s, stride, oy, ox)
        for r, ref in enumerate(refs_s):
            mask = masks[s][..., r:r + 1] if masks is not None else None
            if mask is not None and stride > 1:
                mask = _phase_subsample(mask, stride, oy, ox)
            add(s, ref, warp.warp_coords(depth_t, pose[:, r], K_s, ref.shape[1:3],
                                         rotation_mode, K_t), tgt_t, mask)
    warped_all = warp.sample_many(imgs, xs, ys, padding_mode)

    total = torch.zeros((), dtype=torch.float32, device=tgt_img.device)
    warped_log: list[torch.Tensor] = []
    for (s, tgt, mask, factor), warped, valid in zip(terms, warped_all, valids):
        diff = (tgt - warped) * valid[..., None].to(tgt.dtype)
        if mask is not None:
            diff = diff * mask
        total = total + factor * diff.abs().mean()
        if s == 0:
            warped_log.extend(warped.split(B) if batch_refs else [warped])
    return total, warped_log


def explainability_loss(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean BCE of each per-scale (B, h, w, R) mask toward 1 (keeps the
    masks from collapsing to 0)."""
    total = torch.zeros((), dtype=torch.float32, device=masks[0].device)
    for m in masks:
        total = total + (-torch.log(m.to(torch.float32).clamp(1e-6, 1.0))).mean()
    return total


def _gradient(pred: torch.Tensor):
    """Forward differences of (B, H, W) maps along W and H."""
    return pred[:, :, 1:] - pred[:, :, :-1], pred[:, 1:, :] - pred[:, :-1, :]


def smooth_loss(pred_maps: Sequence[torch.Tensor], scale_decay: float = 2.3) -> torch.Tensor:
    """Second-order gradient penalty over the multi-scale disparities
    ((B, h, w) or (B, h, w, 1)), each scale's weight divided by
    ``scale_decay`` from the last."""
    total = torch.zeros((), dtype=torch.float32, device=pred_maps[0].device)
    weight = 1.0
    for pred in pred_maps:
        if pred.dim() == 4:
            pred = pred[..., 0]
        dx, dy = _gradient(pred)
        dx2, dxdy = _gradient(dx)
        dydx, dy2 = _gradient(dy)
        total = total + weight * (dx2.abs().mean() + dxdy.abs().mean()
                                  + dydx.abs().mean() + dy2.abs().mean())
        weight /= scale_decay
    return total
