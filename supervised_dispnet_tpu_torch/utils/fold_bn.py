"""BatchNorm folding for serving, the port of
``supervised_dispnet_tpu/utils/fold_bn.py``.

In eval mode a BN is an affine map with frozen statistics; absorbing it into
the conv before it (W' = W * g, b' = (b - mean) * g + beta with
g = gamma / sqrt(var + eps)) takes one elementwise pass off each conv. The
functions take the state dict of a BN model and return the one of its
``fold_bn=True`` form (``ResNetEncoder(fold_bn=True)``,
``DispResNet(fold_bn=True)``), in the JAX package's float32 arithmetic.
"""

from __future__ import annotations

import re

import torch

_CONV_BN = re.compile(r"(.*?)(conv(\d)|downsample\.0)\.weight")


def _fold_pair(weight: torch.Tensor, bias: torch.Tensor | None, sd: dict, bn: str,
               eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    # sqrt through float64: correctly rounded, as numpy's (the CPU's
    # vectorized float32 torch.sqrt can be an ulp off)
    var = sd[f"{bn}.running_var"].float() + eps
    g = sd[f"{bn}.weight"].float() / torch.sqrt(var.double()).float()
    b = torch.zeros_like(g) if bias is None else bias.float()
    return (weight.float() * g[:, None, None, None],
            (b - sd[f"{bn}.running_mean"].float()) * g + sd[f"{bn}.bias"].float())


def fold_resnet_encoder(sd: dict[str, torch.Tensor], prefix: str = "",
                        eps: float = 1e-5) -> dict[str, torch.Tensor]:
    """The ``ResNetEncoder`` entries of ``sd`` under ``prefix`` (BN variant)
    -> those of ``ResNetEncoder(fold_bn=True)``: each conv with its BN folded
    in, the BNs gone. Other entries pass through."""
    out: dict[str, torch.Tensor] = {}
    bns = set()
    for key, w in sd.items():
        m = _CONV_BN.fullmatch(key[len(prefix):]) if key.startswith(prefix) else None
        if m is None:
            continue
        base = prefix + m[1]
        conv = base + m[2]
        bn = f"{base}bn{m[3]}" if m[3] else f"{base}downsample.1"
        out[f"{conv}.weight"], out[f"{conv}.bias"] = _fold_pair(
            w, sd.get(f"{conv}.bias"), sd, bn, eps)
        bns.add(bn)
    for key, v in sd.items():
        if key not in out and not any(key.startswith(bn + ".") for bn in bns):
            out[key] = v
    return out


def fold_dispresnet(sd: dict[str, torch.Tensor], eps: float = 1e-5) -> dict[str, torch.Tensor]:
    """A ``DispResNet`` state dict -> the one of ``DispResNet(fold_bn=True)``
    (the decoder has no BN and passes through)."""
    return fold_resnet_encoder(sd, "encoder.", eps)
