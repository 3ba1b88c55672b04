"""DispVggBN: the paper's VGG16-BN encoder ablation. The port of
``supervised_dispnet_tpu/models/disp_vgg_bn.py`` (reference:
``models/disp_vgg_BN.py``).

Takes (B, H, W, 3); returns [disp1, disp2, disp3, disp4], each (B, h, w, 1),
finest first, as the JAX model does. The encoder is torchvision's
``vgg16_bn.features`` (conv-BN-ReLU stages, 2x2 max-pool after each), whose
five pre-pool maps at strides 1..16 are the skips; the decoder upsamples
from stride 32: per stage conv-ELU, 2x bilinear resize to the skip's size,
concat, conv-ELU. With ``fused_upsample`` each stage's (upsample -> concat
-> conv) runs as ``models/common.py::fused_upsample_conv``, as DispResNet's
does, from the same weights. BN is flax-matched (``models/common.py``).
Module names follow the reference state dict: ``encoder.features.{n}``
(torchvision numbering), ``upconv{k}.0``, ``iconv{k}.0``,
``predict_disp{s}.0``.

The encoder and decoder take the trunk's compute dtype (``--bf16``), the
heads compute in float32. Remat (``models/common.py::set_remat``)
checkpoints each encoder stage (its conv-BN-ReLU layers, up to the pool), as
the JAX model does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from supervised_dispnet_tpu_torch.models.common import (
    BatchNorm2d, Conv2d, DispHead, fused_upsample_conv, init_convs_xavier_, remat_call)
from supervised_dispnet_tpu_torch.ops.resize import interpolate_bilinear

# VGG16: conv widths per stage, each stage followed by a 2x2 max-pool
VGG16_STAGES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
DEC_PLANES = (16, 32, 64, 128, 256)


class VggEncoder(nn.Module):
    """``features``: torchvision's vgg16_bn layer list. ``forward(x) ->
    (skips, bottleneck)``: the five pre-pool maps (strides 1, 2, 4, 8, 16)
    and the last pool's output (stride 32). ``remat`` ("full", "conv" or
    None) checkpoints each stage's layers before its pool."""

    remat: str | None = None

    def __init__(self):
        super().__init__()
        layers: list[nn.Module] = []
        self.pools: list[int] = []  # each stage's pool, its index in features
        in_ch = 3
        for widths in VGG16_STAGES:
            for w in widths:
                layers += [Conv2d(in_ch, w, 3, padding=1), BatchNorm2d(w), nn.ReLU()]
                in_ch = w
            self.pools.append(len(layers))
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)

    def _layers(self, start: int, stop: int, x: torch.Tensor) -> torch.Tensor:
        for i in range(start, stop):
            x = self.features[i](x)
        return x

    def forward(self, x: torch.Tensor) -> tuple[list[torch.Tensor], torch.Tensor]:
        skips, start = [], 0
        for pool in self.pools:
            x = remat_call(self.remat, self._layers, start, pool, x)
            skips.append(x)
            x = self.features[pool](x)
            start = pool + 1
        return skips, x


class DispVggBN(nn.Module):
    has_compute_dtype = True

    def __init__(self, fused_upsample: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = VggEncoder()
        self.fused_upsample = fused_upsample
        enc_ch = [stage[-1] for stage in VGG16_STAGES]
        for k in range(4, -1, -1):
            in_ch = enc_ch[4] if k == 4 else DEC_PLANES[k + 1]
            self.add_module(f"upconv{k}", nn.Sequential(
                Conv2d(in_ch, DEC_PLANES[k], 3, padding=1)))
            self.add_module(f"iconv{k}", nn.Sequential(
                Conv2d(DEC_PLANES[k] + enc_ch[k], DEC_PLANES[k], 3, padding=1)))
        for s in range(1, 5):
            self.add_module(f"predict_disp{s}", DispHead(DEC_PLANES[s - 1]))
        # flax defaults: xavier-uniform convs with zero bias, BN scale 1 / bias 0
        init_convs_xavier_(self, generator)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        skips, h = self.encoder(x.permute(0, 3, 1, 2).contiguous())
        outs = []
        for k in range(4, -1, -1):
            h = F.elu(getattr(self, f"upconv{k}")(h))
            skip = skips[k]
            if self.fused_upsample:
                h = fused_upsample_conv(getattr(self, f"iconv{k}")[0], h, skip,
                                        skip.shape[2:], k)
            else:
                h = interpolate_bilinear(h, skip.shape[2], skip.shape[3])
                h = getattr(self, f"iconv{k}")(torch.cat([h, skip], dim=1))
            h = F.elu(h)
            outs.append(h)
        # outs: strides 16, 8, 4, 2, 1; the heads take strides 1, 2, 4, 8
        return [getattr(self, f"predict_disp{s + 1}")(outs[4 - s]).permute(0, 2, 3, 1)
                for s in range(4)]
