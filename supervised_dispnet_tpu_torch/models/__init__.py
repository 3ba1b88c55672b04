"""Model registry by ``--network`` name, the port of
``supervised_dispnet_tpu/models/__init__.py``."""

from __future__ import annotations

import torch

from supervised_dispnet_tpu_torch.models.dispnet import DispNetS
from supervised_dispnet_tpu_torch.models.dispresnet import DispResNet
from supervised_dispnet_tpu_torch.models.posenet import PoseExpNet, PoseNet
from supervised_dispnet_tpu_torch.models.resnet import ResNetEncoder
from supervised_dispnet_tpu_torch.utils.device import resolve_device

_RESNETS = {
    "disp_res": 18,
    "disp_res_18": 18,
    "disp_res_50": 50,
}
# names the JAX package serves that later slices port (see ROADMAP.md)
_LATER = ("disp_vgg_bn", "fcrn")


def get_disp_net(name: str, head: str = "disp", num_bins: int = 64,
                 multiscale_classification: bool = False, fused_upsample: bool = False,
                 seed: int = 0, device: str | torch.device = "cuda") -> torch.nn.Module:
    """Build a disparity network by its ``--network`` name, with weights
    drawn from ``seed``, on ``device`` (the card unless asked otherwise).
    ``head='classification'`` (disp_res* only) gives the bin-logit head of
    ``num_bins`` bins, at all four scales with ``multiscale_classification``."""
    key = name.lower()
    if key in _LATER:
        raise NotImplementedError(
            f"network {name!r} is not ported yet; see ROADMAP.md")
    if key not in _RESNETS and key != "dispnet":
        raise ValueError(f"unknown network {name!r}; choices: "
                         f"{['dispnet', *sorted(_RESNETS), *_LATER]}")
    dev = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    if key == "dispnet":
        if head != "disp":
            raise ValueError(
                f"classification head is only supported on disp_res*, got {name!r}")
        if fused_upsample:
            # as the JAX factory: DispNetS's analog (a pixel-shuffle
            # ConvTranspose) measured negative on the TPU and is not exposed
            raise ValueError(
                "--fused-upsample is only supported on disp_res* / "
                f"disp_vgg_bn (resize->conv decoders), got {name!r}")
        model = DispNetS(generator=generator)
    else:
        model = DispResNet(_RESNETS[key], head=head, num_bins=num_bins,
                           multiscale_classification=multiscale_classification,
                           fused_upsample=fused_upsample, generator=generator)
    return model.to(dev)


__all__ = ["DispNetS", "DispResNet", "PoseExpNet", "PoseNet", "ResNetEncoder",
           "get_disp_net"]
