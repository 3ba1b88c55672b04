"""DispResNet: ResNet-18/50 encoder + upsample-conv decoder with skip concat
and four sigmoid disparity heads, or the depth-as-classification bin-logit
head. The port of ``supervised_dispnet_tpu/models/dispresnet.py``.

Takes (B, H, W, 3). The disparity head returns [disp1, disp2, disp3, disp4],
each (B, h, w, 1), finest first, as the JAX model does; the classification
head returns (B, H, W, num_bins) logits, or with
``multiscale_classification`` a list of four, finest first. With
``fused_upsample`` each decoder stage's (2x upsample -> concat skip -> conv)
runs as ``ops/fused_upconv.py::upconv2x_fused`` of the half-resolution
input plus a 3x3 conv of the skip, from the same weights: the upsampled
tensor never exists, and the state dict is the unfused model's. NCHW inside: the
logits are the ``permute(0, 2, 3, 1)`` view of the conv's NCHW output, not a
copy, which the CE kernels read in place. Module names follow the reference
state dict (``encoder.*``, ``upconv{i}.0``, ``iconv{i}.0``,
``predict_disp{s}.0``, ``predict_class.0`` and ``predict_class{s}.0`` for the
coarser scales s = 2..4).

The encoder and decoder take the trunk's compute dtype (``--bf16``); the
disparity and bin-logit heads compute in float32, as the JAX heads do.
Remat (``models/common.py::set_remat``) checkpoints the encoder's blocks,
as the JAX model does. ``fold_bn=True`` is the BN-folded serving form of the
encoder (``utils/fold_bn.py::fold_dispresnet`` makes its state dict).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from supervised_dispnet_tpu_torch.models.common import (
    Conv2d, DispHead, FloatConv2d, fused_upsample_conv, xavier_uniform_)
from supervised_dispnet_tpu_torch.models.resnet import ResNetEncoder
from supervised_dispnet_tpu_torch.ops.resize import interpolate_bilinear

DEC_PLANES = (16, 32, 64, 128, 256)


def _class_head_name(s: int) -> str:
    """The bin-logit head of decoder scale ``s`` (0 = finest), as the
    reference state dict names it."""
    return "predict_class" if s == 0 else f"predict_class{s + 1}"


class DispResNet(nn.Module):
    has_compute_dtype = True

    def __init__(self, encoder_depth: int = 18, head: str = "disp",
                 num_bins: int = 64, multiscale_classification: bool = False,
                 fused_upsample: bool = False, fold_bn: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if head not in ("disp", "classification"):
            raise ValueError(f"unknown DispResNet head {head!r}")
        self.encoder = ResNetEncoder(encoder_depth, fold_bn=fold_bn)
        enc_ch = self.encoder.feature_channels
        for i in range(4, -1, -1):
            in_ch = enc_ch[4] if i == 4 else DEC_PLANES[i + 1]
            cat_ch = DEC_PLANES[i] + (enc_ch[i - 1] if i > 0 else 0)
            self.add_module(f"upconv{i}", nn.Sequential(
                Conv2d(in_ch, DEC_PLANES[i], 3, padding=1)))
            self.add_module(f"iconv{i}", nn.Sequential(
                Conv2d(cat_ch, DEC_PLANES[i], 3, padding=1)))
        self.head = head
        self.fused_upsample = fused_upsample
        self.multiscale_classification = multiscale_classification
        if head == "disp":
            for s in range(1, 5):
                self.add_module(f"predict_disp{s}", DispHead(DEC_PLANES[s - 1]))
        else:
            for s in range(4 if multiscale_classification else 1):
                self.add_module(_class_head_name(s), nn.Sequential(
                    FloatConv2d(DEC_PLANES[s], num_bins, 3, padding=1)))
        self.init_weights(generator)

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """flax defaults: the encoder's, and xavier-uniform decoder and head
        convs with zero bias."""
        self.encoder.init_weights(generator)
        for name, m in self.named_modules():
            if isinstance(m, nn.Conv2d) and not name.startswith("encoder."):
                xavier_uniform_(m, generator)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor] | torch.Tensor:
        H, W = x.shape[1], x.shape[2]
        enc = self.encoder(x.permute(0, 3, 1, 2).contiguous())
        feats = {}
        h = enc[-1]
        for i in range(4, -1, -1):
            h = F.elu(getattr(self, f"upconv{i}")(h))
            skip = enc[i - 1] if i > 0 else None
            if self.fused_upsample:
                target = tuple(skip.shape[2:]) if skip is not None else (H, W)
                h = F.elu(fused_upsample_conv(getattr(self, f"iconv{i}")[0], h, skip,
                                              target, i))
            else:
                if skip is not None:
                    h = interpolate_bilinear(h, skip.shape[2], skip.shape[3])
                    h = torch.cat([h, skip], dim=1)
                else:
                    h = interpolate_bilinear(h, H, W)
                h = F.elu(getattr(self, f"iconv{i}")(h))
            feats[i] = h
        if self.head == "classification":
            logits = [getattr(self, _class_head_name(s))(feats[s].to(torch.float32))
                      .permute(0, 2, 3, 1)
                      for s in range(4 if self.multiscale_classification else 1)]
            return logits if self.multiscale_classification else logits[0]
        return [getattr(self, f"predict_disp{s + 1}")(feats[s]).permute(0, 2, 3, 1)
                for s in range(4)]

