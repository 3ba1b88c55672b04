"""DispNetS: a conv+ELU encoder-decoder with skip concatenation and four
sigmoid disparity heads. The port of ``supervised_dispnet_tpu/models/dispnet.py``.

Takes (B, H, W, 3) and returns [disp1, disp2, disp3, disp4], each
(B, H/2^s, W/2^s, 1), finest first, as the JAX model does; NCHW inside.
Module names follow the reference state dict (``conv{i}.0`` / ``.2``,
``upconv{i}.0``, ``iconv{i}.0``, ``predict_disp{i}.0``).

The trunk takes the compute dtype (``--bf16``), the heads compute in
float32; the upsampled coarser disparity joins a stage's concat in the
trunk's dtype, the rounding the JAX stage's conv applies to it. Remat
(``models/common.py::set_remat``) checkpoints each encoder stage, upconv and
iconv, as the JAX model does.
"""

from __future__ import annotations

import torch
from torch import nn

from supervised_dispnet_tpu_torch.models.common import (
    ConvELU, DispHead, DownsampleConv, UpConvELU, crop_like, init_convs_xavier_,
    remat_call)
from supervised_dispnet_tpu_torch.ops.resize import interpolate_bilinear

ENC_PLANES = (32, 64, 128, 256, 512, 512, 512)
DEC_PLANES = (512, 512, 256, 128, 64, 32, 16)
ENC_KERNELS = (7, 5, 3, 3, 3, 3, 3)


class DispNetS(nn.Module):
    has_compute_dtype = True
    remat: str | None = None
    max_stride = 128  # seven stride-2 stages (parallel/spatial.py)

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        in_ch = 3
        for n, (planes, k) in enumerate(zip(ENC_PLANES, ENC_KERNELS)):
            self.add_module(f"conv{n + 1}", DownsampleConv(in_ch, planes, k))
            in_ch = planes
        # decoder stage i (7 .. 1): upconv from the stage above, then iconv
        # over [upconv, skip (conv{i-1}), upsampled coarser disparity]
        for i in range(7, 0, -1):
            up_in = ENC_PLANES[6] if i == 7 else DEC_PLANES[6 - i]
            out = DEC_PLANES[7 - i]
            skip = ENC_PLANES[i - 2] if i > 1 else 0
            with_disp = 1 if i <= 3 else 0
            self.add_module(f"upconv{i}", UpConvELU(up_in, out))
            self.add_module(f"iconv{i}", ConvELU(out + skip + with_disp, out))
        for i in range(1, 5):
            self.add_module(f"predict_disp{i}", DispHead(DEC_PLANES[7 - i]))
        init_convs_xavier_(self, generator)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = x.permute(0, 3, 1, 2).contiguous()
        feats = []
        h = x
        for n in range(1, 8):
            h = remat_call(self.remat, getattr(self, f"conv{n}"), h)
            feats.append(h)
        skips = [x] + feats  # skips[i - 1] is the map stage i is cropped to
        disps = {}
        h = feats[6]
        for i in range(7, 0, -1):
            ref = skips[i - 1]
            parts = [crop_like(remat_call(self.remat, getattr(self, f"upconv{i}"), h), ref)]
            if i > 1:
                parts.append(ref)
            if i <= 3:
                up = interpolate_bilinear(disps[i + 1], ref.shape[2], ref.shape[3])
                parts.append(up.to(parts[0].dtype))
            h = remat_call(self.remat, getattr(self, f"iconv{i}"), torch.cat(parts, dim=1))
            if i <= 4:
                disps[i] = getattr(self, f"predict_disp{i}")(h)
        return [disps[i].permute(0, 2, 3, 1) for i in range(1, 5)]
