"""ResNet-18/50 feature encoders, the port of
``supervised_dispnet_tpu/models/resnet.py``.

torchvision layout (stem, ``layer1..4`` of BasicBlock / Bottleneck,
``downsample.0/1``), so the state dict is the reference checkpoint's. BN is
flax-matched (``models/common.py::BatchNorm2d``). Works in NCHW. The convs
and BNs take the trunk's compute dtype (``models/common.py``); with
``remat`` each block is checkpointed (the JAX encoder's ``remat_wrap`` of
its blocks).

``fold_bn=True`` is the serving form with BN absorbed into the convs
(``utils/fold_bn.py``), as the JAX encoder's field: every conv carries a
bias and every BN is the identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from supervised_dispnet_tpu_torch.models.common import (
    BatchNorm2d, Conv2d, kaiming_normal_, remat_call)
from supervised_dispnet_tpu_torch.parallel import spatial


def _norm(ch: int, fold_bn: bool) -> nn.Module:
    """BatchNorm, or the identity where BN is folded into the conv."""
    return nn.Identity() if fold_bn else BatchNorm2d(ch)


def _downsample(in_ch: int, out_ch: int, stride: int,
                fold_bn: bool = False) -> nn.Sequential | None:
    if stride == 1 and in_ch == out_ch:
        return None
    return nn.Sequential(Conv2d(in_ch, out_ch, 1, stride, bias=fold_bn),
                         _norm(out_ch, fold_bn))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1, fold_bn: bool = False):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 3, stride, 1, bias=fold_bn)
        self.bn1 = _norm(features, fold_bn)
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=fold_bn)
        self.bn2 = _norm(features, fold_bn)
        self.downsample = _downsample(in_ch, features, stride, fold_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return F.relu(h + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1, fold_bn: bool = False):
        super().__init__()
        out_ch = features * self.expansion
        self.conv1 = Conv2d(in_ch, features, 1, bias=fold_bn)
        self.bn1 = _norm(features, fold_bn)
        self.conv2 = Conv2d(features, features, 3, stride, 1, bias=fold_bn)
        self.bn2 = _norm(features, fold_bn)
        self.conv3 = Conv2d(features, out_ch, 1, bias=fold_bn)
        self.bn3 = _norm(out_ch, fold_bn)
        self.downsample = _downsample(in_ch, out_ch, stride, fold_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + identity)


# depth -> (block, blocks per stage, feature channels at strides 2..32)
RESNET_SPECS = {
    18: (BasicBlock, (2, 2, 2, 2), (64, 64, 128, 256, 512)),
    50: (Bottleneck, (3, 4, 6, 3), (64, 256, 512, 1024, 2048)),
}


class ResNetEncoder(nn.Module):
    """Returns 5 feature maps at strides 2, 4, 8, 16, 32 (finest first).
    ``remat`` ("full", "conv" or None) checkpoints each block; ``fold_bn``
    gives the BN-folded serving form."""

    remat: str | None = None

    def __init__(self, depth: int = 18, fold_bn: bool = False):
        super().__init__()
        if depth not in RESNET_SPECS:
            raise NotImplementedError(f"ResNet-{depth} is not ported; depths "
                                      f"{sorted(RESNET_SPECS)}")
        block_cls, stage_sizes, self.feature_channels = RESNET_SPECS[depth]
        self.depth = depth
        self.fold_bn = fold_bn
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=fold_bn)
        self.bn1 = _norm(64, fold_bn)
        in_ch = 64
        for stage, (n_blocks, width) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                blocks.append(block_cls(in_ch, width, stride, fold_bn))
                in_ch = width * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """flax defaults: kaiming-normal convs, BN scale 1 / bias 0, for the
        encoder's own layers (a subclass's others are its own)."""
        layers = [self.conv1, self.bn1, self.layer1, self.layer2, self.layer3, self.layer4]
        for m in (m for layer in layers for m in layer.modules()):
            if isinstance(m, nn.Conv2d):
                kaiming_normal_(m, generator)
            elif isinstance(m, BatchNorm2d):
                m.reset_parameters()

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        feats = [h]  # 1/2
        h = spatial.max_pool2d(h, 3, 2, 1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                h = remat_call(self.remat, block, h)
            feats.append(h)  # 1/4, 1/8, 1/16, 1/32
        return feats
