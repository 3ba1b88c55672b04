"""Self-supervised losses: multi-scale photometric inverse-warp L1,
explainability and second-order smoothness. The port of
``supervised_dispnet_tpu/losses/selfsup.py`` (its default arm: one inverse
warp per reference frame and scale, at full resolution).

The image pyramid is 2x2 average pooling, intrinsics are rescaled per scale,
and each term is a mean over all pixels with out-of-view differences zeroed,
as in the reference. The photometric loss samples every (scale, ref) warp
with one ``ops.warp.sample_many`` call: on the card, one grouped kernel
launch each way a step (with ``remat``, one more forward launch when the
backward recomputes the terms).
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
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Sum over scales and reference frames of the mean |tgt - warped ref|,
    with out-of-view pixels zeroed and, when given, weighted by the
    explainability mask.

    tgt_img and each of ref_imgs: (B, H, W, 3); intrinsics (B, 3, 3) at full
    resolution; depths: per-scale target depths (B, H/2^s, W/2^s), finest
    first; explainability_masks: per-scale (B, h, w, R) or None; pose
    (B, R, 6) target->ref. The refs are data: their warps form coordinate
    gradients only. All (scale, ref) warps are sampled together
    (``ops.warp.sample_many``), then the terms are summed scale-major,
    ref-minor. Returns (loss, the finest scale's warped refs).

    ``remat`` checkpoints the terms (pyramid, projections, warps and
    differences): the backward recomputes them instead of holding them, and
    the warped refs come back empty, as the JAX package's remat arm does.
    ``half_res``, ``batch_refs`` and ``stochastic_stride > 1`` are the JAX
    package's other arms; they are not ported.
    """
    for name, value in (("half_res", half_res), ("batch_refs", batch_refs),
                        ("stochastic_stride", stochastic_stride > 1)):
        if value:
            raise NotImplementedError(
                f"photometric loss {name} is not ported yet; see ROADMAP.md")
    args = (tgt_img, ref_imgs, intrinsics, depths, explainability_masks, pose,
            rotation_mode, padding_mode)
    if remat:
        return remat_call("full", lambda: _photometric_terms(*args)[0]), []
    return _photometric_terms(*args)


def _photometric_terms(tgt_img, ref_imgs, intrinsics, depths, explainability_masks, pose,
                       rotation_mode, padding_mode) -> tuple[torch.Tensor, list[torch.Tensor]]:
    tgts, imgs, xs, ys, valids = [], [], [], [], []
    tgt_s, refs_s = tgt_img, list(ref_imgs)
    for s, depth in enumerate(depths):
        if s > 0:
            tgt_s = downsample2x_avg(tgt_s)
            refs_s = [downsample2x_avg(r) for r in refs_s]
        tgts.append(tgt_s)
        K_s = _scale_intrinsics(intrinsics, 1.0 / 2 ** s)
        for r, ref in enumerate(refs_s):
            x, y, valid = warp.warp_coords(depth, pose[:, r], K_s, ref.shape[1:3],
                                           rotation_mode)
            imgs.append(ref)
            xs.append(x)
            ys.append(y)
            valids.append(valid)
    warped_all = warp.sample_many(imgs, xs, ys, padding_mode)

    total = torch.zeros((), dtype=torch.float32, device=tgt_img.device)
    warped_log: list[torch.Tensor] = []
    R = len(ref_imgs)
    for k, (warped, valid) in enumerate(zip(warped_all, valids)):
        s, r = divmod(k, R)
        diff = (tgts[s] - warped) * valid[..., None].to(tgts[s].dtype)
        if explainability_masks is not None:
            diff = diff * explainability_masks[s][..., r:r + 1]
        total = total + diff.abs().mean()
        if s == 0:
            warped_log.append(warped)
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
