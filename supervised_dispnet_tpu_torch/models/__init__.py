"""Model registry by ``--network`` name, the port of
``supervised_dispnet_tpu/models/__init__.py``."""

from __future__ import annotations

import torch

from supervised_dispnet_tpu_torch.models.dispresnet import DispResNet
from supervised_dispnet_tpu_torch.models.resnet import ResNetEncoder
from supervised_dispnet_tpu_torch.utils.device import resolve_device

_REGISTRY = {
    "disp_res": 18,
    "disp_res_18": 18,
    "disp_res_50": 50,
}
# names the JAX package serves that later slices port (see ROADMAP.md)
_LATER = ("dispnet", "disp_vgg_bn", "fcrn")


def get_disp_net(name: str, head: str = "disp", fused_upsample: bool = False,
                 seed: int = 0, device: str | torch.device = "cuda") -> DispResNet:
    """Build a disparity network by its ``--network`` name, with weights
    drawn from ``seed``, on ``device`` (the card unless asked otherwise)."""
    key = name.lower()
    if key in _LATER:
        raise NotImplementedError(
            f"network {name!r} is not ported yet; see ROADMAP.md")
    if key not in _REGISTRY:
        raise ValueError(f"unknown network {name!r}; choices: "
                         f"{sorted(_REGISTRY) + list(_LATER)}")
    dev = resolve_device(device)
    model = DispResNet(_REGISTRY[key], head=head, fused_upsample=fused_upsample,
                       generator=torch.Generator().manual_seed(seed))
    return model.to(dev)


__all__ = ["DispResNet", "ResNetEncoder", "get_disp_net"]
