"""FCRN, Laina et al.'s fully convolutional residual network for depth.
The port of ``supervised_dispnet_tpu/models/fcrn.py`` (reference:
``models/FCRN.py``).

A ResNet-50 encoder to stride 32, a 1x1 conv and BN halving its channels,
four up-projections (each 2x), a 3x3 conv and ReLU, and a bilinear resize
(an upsample) to the input size. Takes (B, H, W, 3) and returns one
(B, H, W, 1) map of metric depth, not a list of disparities: the
(B, H, W, 1) view of the head's (B, 1, H, W) output, as the JAX model
returns it. BN is flax-matched (``models/common.py``).

An up-projection unpools by zero-stuffing (each input at the even
coordinates of a map twice the size) and convolves 5x5 with padding 2. The
JAX package computes that as an input-dilated conv; here it is one
``F.conv_transpose2d`` of stride 2 with the spatially flipped, in/out
swapped kernel (padding 2, output_padding 1), so the zero-stuffed map never
exists. The state dict is the one ``utils/convert_models.py::convert_fcrn``
reads by default: the ResNet-50 at the root (``conv1``, ``bn1``,
``layer1..4``), then ``conv2`` / ``bn2``, ``up{1..4}.{conv,bn}{1,2,3}`` and
``conv3``; the 5x5 weights are the reference's, convolved over the
zero-stuffed map.

FCRN has no compute dtype: it stays float32 under ``--bf16``, as the JAX
model, which has no ``dtype`` field, does. Remat
(``models/common.py::set_remat``) checkpoints the encoder's blocks and each
up-projection, as the JAX model does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from supervised_dispnet_tpu_torch.models.common import (
    BatchNorm2d, FloatConv2d, fake_quant_context, remat_call, xavier_uniform_)
from supervised_dispnet_tpu_torch.models.resnet import ResNetEncoder
from supervised_dispnet_tpu_torch.ops.resize import interpolate_bilinear
from supervised_dispnet_tpu_torch.parallel import spatial


def unpool_conv(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """``conv`` (5x5, padding 2) of x's 2x zero-stuffed unpool (x at even
    rows and columns): (B, Cin, H, W) -> (B, Cout, 2H, 2W). Under QAT the
    fake-quantized conv; the int8 twin's module (``ops/quant.py``) computes
    it itself."""
    if not isinstance(conv, nn.Conv2d):
        return conv(x)
    fq = fake_quant_context(conv)
    if fq is not None:
        return fq.unpool(conv, x)
    w = conv.weight.flip(2, 3).transpose(0, 1)
    return spatial.conv_transpose2d(x, w, conv.bias, stride=2, padding=2, output_padding=1)


class UpProjection(nn.Module):
    """Laina's up-projection: relu(bn2(conv2(relu(bn1(conv1(u))))) +
    bn3(conv3(u))) of the unpooled input u; ``conv1`` and ``conv3`` are 5x5
    over u, ``conv2`` 3x3."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = FloatConv2d(in_ch, out_ch, 5, padding=2)
        self.bn1 = BatchNorm2d(out_ch)
        self.conv2 = FloatConv2d(out_ch, out_ch, 3, padding=1)
        self.bn2 = BatchNorm2d(out_ch)
        self.conv3 = FloatConv2d(in_ch, out_ch, 5, padding=2)
        self.bn3 = BatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = F.relu(self.bn1(unpool_conv(x, self.conv1)))
        a = self.bn2(self.conv2(a))
        return F.relu(a + self.bn3(unpool_conv(x, self.conv3)))


class FCRN(ResNetEncoder):
    """A ``ResNetEncoder(50)`` (its layers at the root of the state dict)
    with the up-projection decoder."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__(50)
        ch = self.feature_channels[-1] // 2
        self.conv2 = FloatConv2d(2 * ch, ch, 1)
        self.bn2 = BatchNorm2d(ch)
        for n in range(1, 5):
            self.add_module(f"up{n}", UpProjection(ch, ch // 2))
            ch //= 2
        self.conv3 = FloatConv2d(ch, 1, 3, padding=1)
        self.init_weights(generator)

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """flax defaults: the encoder's kaiming-normal convs, xavier-uniform
        decoder convs with zero bias, BN scale 1 / bias 0."""
        super().init_weights(generator)
        for layer in (self.conv2, self.up1, self.up2, self.up3, self.up4, self.conv3):
            for m in layer.modules():
                if isinstance(m, nn.Conv2d):
                    xavier_uniform_(m, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = super().forward(x.permute(0, 3, 1, 2).contiguous())[-1]
        return self.decode(h, x.shape[1], x.shape[2])

    def decode(self, h: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """The decoder: stride-32 features (B, 2048, h, w) -> (B, H, W, 1)."""
        h = self.bn2(self.conv2(h))
        for n in range(1, 5):
            h = remat_call(self.remat, getattr(self, f"up{n}"), h)
        h = F.relu(self.conv3(h))
        return interpolate_bilinear(h, H, W).permute(0, 2, 3, 1)
