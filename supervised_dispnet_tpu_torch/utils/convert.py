"""Carry weights across from the JAX package's flax trees.

``dispresnet_from_jax`` takes the ``params`` and ``batch_stats`` trees of the
JAX ``DispResNet`` (nested dicts of arrays, read as numpy) and returns the
port's state dict. The names are those that
``supervised_dispnet_tpu/utils/convert_models.py::export_dispresnet_to_torch``
emits with its default name map, which are the reference checkpoint's, so
the port loads either with ``load_state_dict(strict=True)``.
``dispnet_from_jax`` and ``posexpnet_from_jax`` do the same for DispNetS and
PoseExpNet, under the names ``utils/checkpoint.py::convert_dispnet`` and
``convert_pose_exp_net`` read; ``disp_vgg_bn_from_jax`` and ``fcrn_from_jax``
for DispVggBN and FCRN, under the names ``utils/convert_models.py::
convert_network`` reads. ``dispresnet_folded_from_jax`` takes the tree of
the JAX ``utils/fold_bn.py::fold_dispresnet`` into ``DispResNet(fold_bn=True)``.

``flax_paths`` maps the port's module names to the JAX modules' flax paths
(``encoder/layer1_0/conv1``, ``upconv3_1/Conv_0``), the keys of the int8
calibration ranges (``ops/quant.py``); ``port_name`` is its inverse.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from supervised_dispnet_tpu_torch.models.resnet import RESNET_SPECS, ResNetEncoder


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


def _put_bn(sd: dict, prefix: str, p: dict, s: dict) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])


def _put_resnet(sd: dict, prefix: str, ep: dict, es: dict, depth: int) -> None:
    """A JAX ``ResNetEncoder``'s params / batch_stats under ``prefix``, in
    torchvision's layout."""
    sd[f"{prefix}conv1.weight"] = j2t_conv(ep["conv1"]["kernel"])
    _put_bn(sd, f"{prefix}bn1", ep["bn1"], es["bn1"])
    block_cls, stage_sizes, _ = RESNET_SPECS[depth]
    n_convs = 3 if block_cls.expansion == 4 else 2
    for stage, n_blocks in enumerate(stage_sizes):
        for b in range(n_blocks):
            jp, js = ep[f"layer{stage + 1}_{b}"], es[f"layer{stage + 1}_{b}"]
            block = f"{prefix}layer{stage + 1}.{b}"
            for c in range(1, n_convs + 1):
                sd[f"{block}.conv{c}.weight"] = j2t_conv(jp[f"conv{c}"]["kernel"])
                _put_bn(sd, f"{block}.bn{c}", jp[f"bn{c}"], js[f"bn{c}"])
            if "downsample_conv" in jp:
                sd[f"{block}.downsample.0.weight"] = j2t_conv(jp["downsample_conv"]["kernel"])
                _put_bn(sd, f"{block}.downsample.1", jp["downsample_bn"], js["downsample_bn"])


def convert_resnet_encoder(sd: dict[str, torch.Tensor], depth: int = 18
                           ) -> dict[str, torch.Tensor]:
    """A torchvision ResNet-18/50 state dict (ImageNet initialisation) ->
    the state dict of the port's ``ResNetEncoder`` of that depth
    (``DispResNet.encoder``), as the JAX package's
    ``utils/checkpoint.py::convert_resnet_encoder`` converts it: every conv
    and BN, running statistics included; ``fc.*`` is dropped. The encoder
    has torchvision's names, so the keys carry over as they are
    (``num_batches_tracked`` too, where the file has it). A missing key
    raises ``KeyError`` naming it."""
    if depth not in RESNET_SPECS:
        raise ValueError(f"no ResNet-{depth} encoder; depths {sorted(RESNET_SPECS)}")
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    with torch.device("meta"):
        keys = list(ResNetEncoder(depth).state_dict())
    missing = [k for k in keys if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"not a torchvision ResNet-{depth} state dict: no "
                       f"{', '.join(missing[:4])}{' ...' if len(missing) > 4 else ''}")
    return {k: sd[k].clone() if k.endswith("num_batches_tracked")
            else sd[k].to(torch.float32).clone() for k in keys if k in sd}


def dispresnet_from_jax(params: dict, batch_stats: dict, depth: int = 18,
                        head: str = "disp",
                        multiscale_classification: bool = False) -> dict[str, torch.Tensor]:
    """JAX DispResNet ``params`` / ``batch_stats`` -> the port's
    ``DispResNet`` state dict. The classification head's ``bin_head`` goes to
    ``predict_class.0`` and, multi-scale, ``bin_head{s}`` to
    ``predict_class{s+1}.0``: the names of the JAX package's
    ``DispResNetNameMap.bin_head`` / ``bin_head_scale``."""
    sd: dict[str, torch.Tensor] = {}
    _put_resnet(sd, "encoder.", params["encoder"], batch_stats["encoder"], depth)
    _put_dispresnet_decoder(sd, params, head, multiscale_classification)
    return sd


def _put_dispresnet_decoder(sd: dict, params: dict, head: str,
                            multiscale_classification: bool) -> None:
    for i in range(5):
        _put(sd, f"upconv{i}.0", params[f"upconv{i}_0"]["Conv_0"])
        _put(sd, f"iconv{i}.0", params[f"upconv{i}_1"]["Conv_0"])
    if head == "classification":
        _put(sd, "predict_class.0", params["bin_head"])
        if multiscale_classification:
            for s in range(1, 4):
                _put(sd, f"predict_class{s + 1}.0", params[f"bin_head{s}"])
    else:
        for s in range(4):
            _put(sd, f"predict_disp{s + 1}.0", params[f"disp_head{s}"]["Conv_0"])


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


# torchvision vgg16_bn ``features`` index of each stage's convs (BN at + 1)
VGG16_BN_CONV_IDX = ((0, 3), (7, 10), (14, 17, 20), (24, 27, 30), (34, 37, 40))


def disp_vgg_bn_from_jax(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """JAX DispVggBN ``params`` / ``batch_stats`` -> the port's ``DispVggBN``
    state dict, under the names ``utils/convert_models.py::
    convert_disp_vgg_bn`` reads with its default ``DispVggNameMap``
    (``encoder.features.{n}``, ``upconv{k}.0``, ``iconv{k}.0``,
    ``predict_disp{s}.0``). The fused and unfused JAX models share one tree."""
    sd: dict[str, torch.Tensor] = {}
    for s, idxs in enumerate(VGG16_BN_CONV_IDX):
        sp, ss = params[f"stage{s}"], batch_stats[f"stage{s}"]
        for c, idx in enumerate(idxs):
            _put(sd, f"encoder.features.{idx}", sp[f"conv{c}"])
            _put_bn(sd, f"encoder.features.{idx + 1}", sp[f"bn{c}"], ss[f"bn{c}"])
    for k in range(5):
        _put(sd, f"upconv{k}.0", params[f"up{k}_0"])
        _put(sd, f"iconv{k}.0", params[f"up{k}_1"])
    for s in range(4):
        _put(sd, f"predict_disp{s + 1}.0", params[f"disp_head{s}"]["Conv_0"])
    return sd


def fcrn_from_jax(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """JAX FCRN ``params`` / ``batch_stats`` -> the port's ``FCRN`` state
    dict, under the names ``utils/convert_models.py::convert_fcrn`` reads
    with its default ``FCRNNameMap``: the ResNet-50 at the root, ``conv2``,
    ``bn2``, ``up{n}`` (``conv_a`` / ``bn_a`` -> ``conv1`` / ``bn1``,
    ``conv_a2`` / ``bn_a2`` -> 2, ``conv_b`` / ``bn_b`` -> 3), ``conv3``. The
    input-dilated conv's kernel is the unpooled map's conv kernel as it is."""
    sd: dict[str, torch.Tensor] = {}
    _put_resnet(sd, "", params["encoder"], batch_stats["encoder"], 50)
    _put(sd, "conv2", params["conv2"])
    _put_bn(sd, "bn2", params["bn2"], batch_stats["bn2"])
    for i in range(4):
        up, ups = params[f"up{i}"], batch_stats[f"up{i}"]
        for ours, conv, bn in ((1, "conv_a", "bn_a"), (2, "conv_a2", "bn_a2"),
                               (3, "conv_b", "bn_b")):
            _put(sd, f"up{i + 1}.conv{ours}", up[conv])
            _put_bn(sd, f"up{i + 1}.bn{ours}", up[bn], ups[bn])
    _put(sd, "conv3", params["conv3"])
    return sd


def _put_resnet_folded(sd: dict, prefix: str, ep: dict, depth: int) -> None:
    """A folded JAX ``ResNetEncoder``'s params (every conv with a bias, no BN)
    under ``prefix``, in torchvision's layout."""
    _put(sd, f"{prefix}conv1", ep["conv1"])
    block_cls, stage_sizes, _ = RESNET_SPECS[depth]
    n_convs = 3 if block_cls.expansion == 4 else 2
    for stage, n_blocks in enumerate(stage_sizes):
        for b in range(n_blocks):
            jp = ep[f"layer{stage + 1}_{b}"]
            block = f"{prefix}layer{stage + 1}.{b}"
            for c in range(1, n_convs + 1):
                _put(sd, f"{block}.conv{c}", jp[f"conv{c}"])
            if "downsample_conv" in jp:
                _put(sd, f"{block}.downsample.0", jp["downsample_conv"])


def dispresnet_folded_from_jax(params: dict, depth: int = 18, head: str = "disp",
                               multiscale_classification: bool = False
                               ) -> dict[str, torch.Tensor]:
    """The params of JAX ``fold_dispresnet(params, batch_stats)`` (a
    ``DispResNet(fold_bn=True)`` tree) -> the port's ``DispResNet(fold_bn=True)``
    state dict: the encoder's convs with their folded biases, the decoder and
    heads as ``dispresnet_from_jax`` names them."""
    sd: dict[str, torch.Tensor] = {}
    _put_resnet_folded(sd, "encoder.", params["encoder"], depth)
    _put_dispresnet_decoder(sd, params, head, multiscale_classification)
    return sd


def _resnet_rules(port: str, flax: str) -> list:
    p = re.escape(port)
    return [
        (p + r"conv1", lambda m: f"{flax}conv1"),
        (p + r"layer(\d)\.(\d+)\.conv(\d)", lambda m: f"{flax}layer{m[1]}_{m[2]}/conv{m[3]}"),
        (p + r"layer(\d)\.(\d+)\.downsample\.0",
         lambda m: f"{flax}layer{m[1]}_{m[2]}/downsample_conv"),
        (p + r"layer(\d)\.(\d+)", lambda m: f"{flax}layer{m[1]}_{m[2]}"),
    ]


def _vgg_conv(m: re.Match) -> str | None:
    idx = int(m[1])
    for s, idxs in enumerate(VGG16_BN_CONV_IDX):
        if idx in idxs:
            return f"stage{s}/conv{idxs.index(idx)}"
    return None


# port module name (fullmatch) -> flax path, by network class name
_FLAX_RULES = {
    "DispResNet": _resnet_rules("encoder.", "encoder/") + [
        (r"upconv(\d)\.0", lambda m: f"upconv{m[1]}_0/Conv_0"),
        (r"iconv(\d)\.0", lambda m: f"upconv{m[1]}_1/Conv_0"),
        (r"predict_disp(\d)\.0", lambda m: f"disp_head{int(m[1]) - 1}/Conv_0"),
        (r"predict_class\.0", lambda m: "bin_head"),
        (r"predict_class(\d)\.0", lambda m: f"bin_head{int(m[1]) - 1}"),
    ],
    "DispNetS": [
        (r"conv(\d)\.0", lambda m: f"conv{m[1]}/conv_a/Conv_0"),
        (r"conv(\d)\.2", lambda m: f"conv{m[1]}/conv_b/Conv_0"),
        (r"conv(\d)", lambda m: f"conv{m[1]}"),
        (r"upconv(\d)\.0", lambda m: f"upconv{m[1]}/ConvTranspose_0"),
        (r"iconv(\d)\.0", lambda m: f"iconv{m[1]}/Conv_0"),
        (r"predict_disp(\d)\.0", lambda m: f"predict_disp{m[1]}/Conv_0"),
    ],
    "DispVggBN": [
        (r"encoder\.features\.(\d+)", _vgg_conv),
        (r"upconv(\d)\.0", lambda m: f"up{m[1]}_0"),
        (r"iconv(\d)\.0", lambda m: f"up{m[1]}_1"),
        (r"predict_disp(\d)\.0", lambda m: f"disp_head{int(m[1]) - 1}/Conv_0"),
    ],
    "FCRN": _resnet_rules("", "encoder/") + [
        (r"conv2", lambda m: "conv2"),
        (r"up(\d)\.conv1", lambda m: f"up{int(m[1]) - 1}/conv_a"),
        (r"up(\d)\.conv2", lambda m: f"up{int(m[1]) - 1}/conv_a2"),
        (r"up(\d)\.conv3", lambda m: f"up{int(m[1]) - 1}/conv_b"),
        (r"up(\d)", lambda m: f"up{int(m[1]) - 1}"),
        (r"conv3", lambda m: "conv3"),
    ],
}


def flax_paths(model: torch.nn.Module) -> dict[str, str]:
    """{port module name: the JAX module's flax path} for the convs (and the
    ResNet blocks, DispNetS's stages, FCRN's up-projections) of a registry
    network: ``encoder.layer1.0.conv1`` -> ``encoder/layer1_0/conv1``,
    ``iconv3.0`` -> ``upconv3_1/Conv_0``, FCRN's ``up1.conv3`` ->
    ``up0/conv_b``. The int8 calibration's range keys are these paths."""
    rules = _FLAX_RULES.get(type(model).__name__)
    if rules is None:
        raise ValueError(f"no flax path table for {type(model).__name__}")
    out = {}
    for name, _ in model.named_modules():
        for pattern, fn in rules:
            m = re.fullmatch(pattern, name)
            if m is not None:
                path = fn(m)
                if path is not None:
                    out[name] = path
                break
    return out


def port_name(model: torch.nn.Module, path: str) -> str:
    """The port module name of flax ``path`` (a range key's ``::`` suffix
    dropped); ``KeyError`` if the network has no such module."""
    base = path.split("::")[0]
    for name, p in flax_paths(model).items():
        if p == base:
            return name
    raise KeyError(f"{type(model).__name__} has no module at flax path {base!r}")
