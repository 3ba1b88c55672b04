"""Pose and explainability networks for self-supervised snippets. The port
of ``supervised_dispnet_tpu/models/posenet.py``.

A stride-2 conv+ELU encoder over the channel-concatenated (target, refs)
snippet; a 1x1 pose head, averaged over space and scaled by 0.01, giving
6-DoF per reference frame; and, with ``output_exp``, a transposed-conv
decoder giving four sigmoid explainability masks. Inputs and masks are NHWC
at the interface, NCHW inside. The encoder and decoder take the trunk's
compute dtype (``--bf16``); the pose and mask heads run in float32.
Module names follow the reference state dict (``conv{i}.0``, ``pose_pred``,
``upconv{i}.0``, ``predict_mask{i}``).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from supervised_dispnet_tpu_torch.models.common import (
    ConvELU, UpConvELU, crop_like, init_convs_xavier_)

ENC_PLANES = (16, 32, 64, 128, 256, 256, 256)
ENC_KERNELS = (7, 5, 3, 3, 3, 3, 3)
DEC_PLANES = (256, 128, 64, 32, 16)
POSE_SCALE = 0.01


class PoseExpNet(nn.Module):
    """``forward(tgt, refs) -> (exp_masks or None, pose)``: tgt (B, H, W, 3),
    refs a list of ``nb_ref_imgs`` (B, H, W, 3); pose (B, nb_ref_imgs, 6);
    exp_masks four (B, H/2^s, W/2^s, nb_ref_imgs) masks, finest first, or
    None when ``output_exp`` is False."""

    has_compute_dtype = True

    def __init__(self, nb_ref_imgs: int = 2, output_exp: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.nb_ref_imgs = nb_ref_imgs
        self.output_exp = output_exp
        in_ch = 3 * (1 + nb_ref_imgs)
        for n, (planes, k) in enumerate(zip(ENC_PLANES, ENC_KERNELS)):
            self.add_module(f"conv{n + 1}", ConvELU(in_ch, planes, k, stride=2))
            in_ch = planes
        self.pose_pred = nn.Conv2d(ENC_PLANES[6], 6 * nb_ref_imgs, 1)
        if output_exp:
            # upconv5 starts from conv5; upconv{i} feeds predict_mask{i}
            up_in = ENC_PLANES[4]
            for i, planes in zip(range(5, 0, -1), DEC_PLANES):
                self.add_module(f"upconv{i}", UpConvELU(up_in, planes))
                up_in = planes
            for i in range(4, 0, -1):
                self.add_module(f"predict_mask{i}",
                                nn.Conv2d(DEC_PLANES[5 - i], nb_ref_imgs, 3, padding=1))
        init_convs_xavier_(self, generator)

    def forward(self, tgt: torch.Tensor, refs: Sequence[torch.Tensor]):
        if len(refs) != self.nb_ref_imgs:
            raise ValueError(f"expected {self.nb_ref_imgs} reference frames, got {len(refs)}")
        x = torch.cat([tgt, *refs], dim=-1).permute(0, 3, 1, 2).contiguous()
        feats = []
        h = x
        for n in range(1, 8):
            h = getattr(self, f"conv{n}")(h)
            feats.append(h)
        pose = self.pose_pred(feats[6].to(torch.float32)).mean(dim=(2, 3)) * POSE_SCALE
        pose = pose.reshape(pose.shape[0], self.nb_ref_imgs, 6)
        if not self.output_exp:
            return None, pose
        # upconv{i} is cropped to conv{i-1}'s map (the input for i = 1)
        crops = [x] + feats
        masks = {}
        h = feats[4]
        for i in range(5, 0, -1):
            h = crop_like(getattr(self, f"upconv{i}")(h), crops[i - 1])
            if i <= 4:
                logits = getattr(self, f"predict_mask{i}")(h.to(torch.float32))
                masks[i] = torch.sigmoid(logits).permute(0, 2, 3, 1)
        return [masks[i] for i in range(1, 5)], pose


class PoseNet(PoseExpNet):
    """Pose only: ``forward(tgt, refs) -> pose`` (B, nb_ref_imgs, 6); the
    explainability decoder is not built. No compute dtype, as the JAX
    ``PoseNet`` has none."""

    has_compute_dtype = False

    def __init__(self, nb_ref_imgs: int = 2, generator: torch.Generator | None = None):
        super().__init__(nb_ref_imgs, output_exp=False, generator=generator)

    def forward(self, tgt: torch.Tensor, refs: Sequence[torch.Tensor]) -> torch.Tensor:
        return super().forward(tgt, refs)[1]
