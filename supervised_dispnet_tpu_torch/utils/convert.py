"""Carry weights across from the JAX package's flax trees.

``dispresnet_from_jax`` takes the ``params`` and ``batch_stats`` trees of the
JAX ``DispResNet`` (nested dicts of arrays, read as numpy) and returns the
port's state dict. The names are those that
``supervised_dispnet_tpu/utils/convert_models.py::export_dispresnet_to_torch``
emits with its default name map, which are the reference checkpoint's, so
the port loads either with ``load_state_dict(strict=True)``.
``dispnet_from_jax`` and ``posexpnet_from_jax`` do the same for DispNetS and
PoseExpNet, under the names ``utils/checkpoint.py::convert_dispnet`` and
``convert_pose_exp_net`` read.
"""

from __future__ import annotations

import numpy as np
import torch

from supervised_dispnet_tpu_torch.models.resnet import RESNET_SPECS


def j2t_conv(kernel) -> torch.Tensor:
    """flax conv kernel (kh, kw, I, O) -> torch Conv2d weight (O, I, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def j2t_conv_transpose(kernel) -> torch.Tensor:
    """flax ``nn.ConvTranspose`` kernel (kh, kw, I, O) -> torch
    ``ConvTranspose2d`` weight (I, O, kh, kw): the inverse of the JAX
    package's ``t2j_conv_transpose``, which transposes and then flips both
    spatial axes, so here the flip comes first."""
    k = np.asarray(kernel, np.float32)[::-1, ::-1]
    return torch.from_numpy(np.ascontiguousarray(k.transpose(2, 3, 0, 1)))


def _put(sd: dict, prefix: str, leaf: dict, transpose: bool = False) -> None:
    sd[f"{prefix}.weight"] = (j2t_conv_transpose if transpose else j2t_conv)(leaf["kernel"])
    sd[f"{prefix}.bias"] = _t(leaf["bias"])


def dispresnet_from_jax(params: dict, batch_stats: dict,
                        depth: int = 18) -> dict[str, torch.Tensor]:
    """JAX DispResNet (disparity head) ``params`` / ``batch_stats`` -> the
    port's ``DispResNet`` state dict."""
    sd: dict[str, torch.Tensor] = {}
    ep, es = params["encoder"], batch_stats["encoder"]

    def put_bn(prefix: str, p: dict, s: dict) -> None:
        sd[f"{prefix}.weight"] = _t(p["scale"])
        sd[f"{prefix}.bias"] = _t(p["bias"])
        sd[f"{prefix}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}.running_var"] = _t(s["var"])

    sd["encoder.conv1.weight"] = j2t_conv(ep["conv1"]["kernel"])
    put_bn("encoder.bn1", ep["bn1"], es["bn1"])
    block_cls, stage_sizes, _ = RESNET_SPECS[depth]
    n_convs = 3 if block_cls.expansion == 4 else 2
    for stage, n_blocks in enumerate(stage_sizes):
        for b in range(n_blocks):
            jax_name = f"layer{stage + 1}_{b}"
            prefix = f"encoder.layer{stage + 1}.{b}"
            for c in range(1, n_convs + 1):
                sd[f"{prefix}.conv{c}.weight"] = j2t_conv(ep[jax_name][f"conv{c}"]["kernel"])
                put_bn(f"{prefix}.bn{c}", ep[jax_name][f"bn{c}"], es[jax_name][f"bn{c}"])
            if "downsample_conv" in ep[jax_name]:
                sd[f"{prefix}.downsample.0.weight"] = j2t_conv(
                    ep[jax_name]["downsample_conv"]["kernel"])
                put_bn(f"{prefix}.downsample.1", ep[jax_name]["downsample_bn"],
                       es[jax_name]["downsample_bn"])
    for i in range(5):
        _put(sd, f"upconv{i}.0", params[f"upconv{i}_0"]["Conv_0"])
        _put(sd, f"iconv{i}.0", params[f"upconv{i}_1"]["Conv_0"])
    for s in range(4):
        _put(sd, f"predict_disp{s + 1}.0", params[f"disp_head{s}"]["Conv_0"])
    return sd


def dispnet_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX DispNetS ``params`` -> the port's ``DispNetS`` state dict, under
    the names ``supervised_dispnet_tpu/utils/checkpoint.py::convert_dispnet``
    reads (the reference checkpoint's)."""
    sd: dict[str, torch.Tensor] = {}
    for i in range(1, 8):
        _put(sd, f"conv{i}.0", params[f"conv{i}"]["conv_a"]["Conv_0"])
        _put(sd, f"conv{i}.2", params[f"conv{i}"]["conv_b"]["Conv_0"])
    for i in range(1, 8):
        _put(sd, f"upconv{i}.0", params[f"upconv{i}"]["ConvTranspose_0"], transpose=True)
        _put(sd, f"iconv{i}.0", params[f"iconv{i}"]["Conv_0"])
    for i in range(1, 5):
        _put(sd, f"predict_disp{i}.0", params[f"predict_disp{i}"]["Conv_0"])
    return sd


def posexpnet_from_jax(params: dict, output_exp: bool = True) -> dict[str, torch.Tensor]:
    """JAX PoseExpNet ``params`` -> the port's ``PoseExpNet`` state dict,
    under the names ``convert_pose_exp_net`` reads. For the JAX ``PoseNet``,
    pass its ``params["PoseExpNet_0"]`` with ``output_exp=False``."""
    sd: dict[str, torch.Tensor] = {}
    for i in range(1, 8):
        _put(sd, f"conv{i}.0", params[f"conv{i}"]["Conv_0"])
    _put(sd, "pose_pred", params["pose_pred"])
    if output_exp:
        for i in range(1, 6):
            _put(sd, f"upconv{i}.0", params[f"upconv{i}"]["ConvTranspose_0"],
                 transpose=True)
        for i in range(1, 5):
            _put(sd, f"predict_mask{i}", params[f"predict_mask{i}"])
    return sd
