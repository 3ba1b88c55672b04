"""Model registry by ``--network`` name, the port of
``supervised_dispnet_tpu/models/__init__.py``."""

from __future__ import annotations

import torch

from supervised_dispnet_tpu_torch.models.common import set_compute_dtype, set_remat
from supervised_dispnet_tpu_torch.models.disp_vgg_bn import DispVggBN
from supervised_dispnet_tpu_torch.models.dispnet import DispNetS
from supervised_dispnet_tpu_torch.models.dispresnet import DispResNet
from supervised_dispnet_tpu_torch.models.fcrn import FCRN
from supervised_dispnet_tpu_torch.models.posenet import PoseExpNet, PoseNet
from supervised_dispnet_tpu_torch.models.resnet import ResNetEncoder
from supervised_dispnet_tpu_torch.utils.device import resolve_device

_RESNETS = {
    "disp_res": 18,
    "disp_res_18": 18,
    "disp_res_50": 50,
}
_NETWORKS = ("dispnet", *_RESNETS, "disp_vgg_bn", "fcrn")


def get_disp_net(name: str, head: str = "disp", num_bins: int = 64,
                 multiscale_classification: bool = False, fused_upsample: bool = False,
                 remat: bool | str = False, bf16: bool = False, seed: int = 0,
                 device: str | torch.device = "cuda") -> torch.nn.Module:
    """Build a disparity (or, ``fcrn``, metric depth) network by its
    ``--network`` name, with weights drawn from ``seed``, on ``device`` (the
    card unless asked otherwise). ``head='classification'`` (disp_res*
    only) gives the bin-logit head of ``num_bins`` bins, at all four scales
    with ``multiscale_classification``. ``remat`` (True or "full", "conv")
    checkpoints the stages the JAX factory's does. ``bf16`` computes the
    trunk in bfloat16 with float32 parameters and heads
    (``models/common.py::set_compute_dtype``); FCRN has no such trunk and
    stays float32, as in the JAX package."""
    key = name.lower()
    if key not in _NETWORKS:
        raise ValueError(f"unknown network {name!r}; choices: {sorted(_NETWORKS)}")
    if head != "disp" and key not in _RESNETS:
        raise ValueError(
            f"classification head is only supported on disp_res*, got {name!r}")
    if fused_upsample and key in ("dispnet", "fcrn"):
        # as the JAX factory: DispNetS's analog (a pixel-shuffle
        # ConvTranspose) measured negative on the TPU and is not exposed;
        # FCRN has no resize->conv decoder
        raise ValueError(
            "--fused-upsample is only supported on disp_res* / "
            f"disp_vgg_bn (resize->conv decoders), got {name!r}")
    dev = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    if key == "dispnet":
        model = DispNetS(generator=generator)
    elif key == "disp_vgg_bn":
        model = DispVggBN(fused_upsample=fused_upsample, generator=generator)
    elif key == "fcrn":
        model = FCRN(generator=generator)
    else:
        model = DispResNet(_RESNETS[key], head=head, num_bins=num_bins,
                           multiscale_classification=multiscale_classification,
                           fused_upsample=fused_upsample, generator=generator)
    set_remat(model, remat)
    if bf16:
        set_compute_dtype(model, torch.bfloat16)
    return model.to(dev)


__all__ = ["FCRN", "DispNetS", "DispResNet", "DispVggBN", "PoseExpNet",
           "PoseNet", "ResNetEncoder", "get_disp_net"]
