"""int8 post-training quantization (PTQ) for serving, and quantization-aware
training (QAT): the port of ``supervised_dispnet_tpu/ops/quant.py``.

Scheme (symmetric, as the JAX package's):
- weights per output channel, ``w_scale = max|W| / 127``, quantized once
  when the int8 twin is built (``bake_int8_weights``);
- activations per tensor with static scales from a calibration pass
  (``calibrate_conv_ranges``: the max, or a percentile, of each quantizable
  conv's ``|input|`` over the batches), ``scale = float32(range / 127)``;
- int32 accumulation and a float32 epilogue in the int8 convolution
  (``ops/cuda/int8_conv.py``: the hand-written kernel on the card, its plain
  version on the CPU);
- the disparity heads (one output channel), grouped convs and the
  transposed convs (DispNetS's upconvs) stay in float; with no ``exempt``
  predicate the disparity heads run in bf16 (``BF16DispHead``).

Range keys are the JAX modules' flax paths (``encoder/layer1_0/conv1``,
``upconv3_1/Conv_0::skip``, ``encoder/layer2_0::out``), mapped to the port's
modules by ``utils/convert.py::flax_paths``, so the two calibrations compare
key for key.

**The int8 twin.** ``QuantizedModel(model, ranges, exempt=None, baked=None)``
is an eval-only copy of a registry network in which every calibrated conv is
an int8 module holding its int8 weights, scales and biases as buffers, so a
forward reads no float32 kernel of a quantized conv. With no ``exempt``
predicate the int8-through chains run, as in the JAX package:
- the ResNet encoder (``Int8ResNetEncoder``, DispResNet and FCRN): every
  conv requantizes in its epilogue (BN folded into the weights, ReLU, the
  residual add; at a block with a downsample conv both sides are rounded to
  bf16 before the add), the stem's max pool runs on int8; it needs the
  blocks' ``::out`` keys;
- VGG-BN's stages (``Int8VggEncoder``) and DispNetS's ``DownsampleConv``
  blocks (``Int8DownsampleConv``), from the per-conv keys alone;
- the fused DispResNet decoder (``QuantizedModel._dispresnet_chain``):
  activations cross between decoder stages as int8 (``QAct``).
Any ``exempt`` predicate (even ``lambda m: False``) forces the per-conv and
per-stage path. ``quantized_apply`` builds a twin and runs it; build the
twin once to serve many batches.

**QAT.** ``fake_quant_methods(exempt=None)`` is a context manager: inside
it every quantizable conv (``models/common.py`` reads it) runs a
quantize-dequantize of its input (per tensor, dynamic absmax) and weight
(per output channel) with a straight-through gradient, in float32, and the
fused decoder stage mirrors the int8 stage's arithmetic.

``DISPNET_TPU_DEC_CHAIN`` (the JAX module's switch for benchmarking the
decoder chain) is not ported.
"""

from __future__ import annotations

import contextlib
import copy
from collections.abc import Callable, Iterable
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from supervised_dispnet_tpu_torch.models.common import FAKE_QUANT, DispHead, DownsampleConv
from supervised_dispnet_tpu_torch.models.disp_vgg_bn import DispVggBN, VggEncoder
from supervised_dispnet_tpu_torch.models.dispnet import DispNetS
from supervised_dispnet_tpu_torch.models.dispresnet import DispResNet
from supervised_dispnet_tpu_torch.models.fcrn import FCRN, UpProjection
from supervised_dispnet_tpu_torch.models.resnet import BasicBlock, Bottleneck, ResNetEncoder
from supervised_dispnet_tpu_torch.ops.cuda.int8_conv import Geometry, int8_conv, pack_weight
from supervised_dispnet_tpu_torch.ops.fused_upconv import border_corrections, upconv2x_fused
from supervised_dispnet_tpu_torch.parallel.mesh import all_reduce_max
from supervised_dispnet_tpu_torch.utils.convert import flax_paths

Exempt = Callable[[nn.Module], bool] | None

# FCRN's unpool conv as JAX computes it: the 5x5 kernel over the input
# dilated by 2 (lhs dilation), padding (2, 3) on each axis
UNPOOL_GEOMETRY = Geometry(5, 5, (1, 1), (2, 3, 2, 3), (2, 2))
# the fused decoder stage's main conv: the composed 6x6 kernel over the
# edge-padded half-resolution input dilated by 2, padding 1
FUSED_GEOMETRY = Geometry(6, 6, (1, 1), (1, 1, 1, 1), (2, 2))


def scale_of(rng: float) -> float:
    """A range's symmetric int8 scale, ``jnp.float32(rng / 127.0)``: the
    division in double, then rounded to float32."""
    return float(np.float32(rng / 127.0))


def is_quantizable(conv: nn.Module, exempt: Exempt = None) -> bool:
    """JAX ``_is_quantizable``: an ungrouped conv with more than one output
    channel (the bin-logit heads are in; the disparity heads and FCRN's
    depth conv are out), not ``exempt``."""
    return (isinstance(conv, nn.Conv2d) and conv.groups == 1 and conv.out_channels > 1
            and not (exempt is not None and exempt(conv)))


# ---------------------------------------------------------------------------
# int8 tensors
# ---------------------------------------------------------------------------


def _t(v: float, device) -> torch.Tensor:
    """A 0-dim float32 tensor on ``device``: dividing by it is a true
    division on the card too (a host scalar becomes a reciprocal product)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def _per127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` as a true division on every device, as JAX's scales."""
    return x / _t(127.0, x.device)


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """float -> int8 ``clip(round(x / scale), -127, 127)``, contiguous in x's
    shape (JAX ``_quantize_fp``)."""
    return torch.clamp(torch.round(x.to(torch.float32) / scale), -127.0, 127.0
                       ).to(torch.int8).contiguous()


def dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


class QAct(NamedTuple):
    """An int8 activation (NHWC) and its scale (a 0-dim tensor), handed
    between the stages of the int8 decoder chain (JAX ``_QAct``)."""

    q: torch.Tensor
    scale: torch.Tensor

    def dequant(self) -> torch.Tensor:
        return dequant(self.q, self.scale)


def maxpool_q(q: torch.Tensor) -> torch.Tensor:
    """3x3/2 padding-1 max pool of NHWC int8 (JAX ``_maxpool_q``): exact in
    a float type, since every window holds a valid element."""
    dt = torch.float16 if q.is_cuda else torch.float32
    y = F.max_pool2d(q.permute(0, 3, 1, 2).to(dt), 3, 2, 1)
    return y.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def edge_pad(q: torch.Tensor) -> torch.Tensor:
    """NHWC -> its 1-pixel edge-replicated padding, any dtype."""
    H, W = q.shape[1:3]
    rows = torch.arange(-1, H + 1, device=q.device).clamp(0, H - 1)
    cols = torch.arange(-1, W + 1, device=q.device).clamp(0, W - 1)
    return q[:, rows][:, :, cols].contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def _reduce(a: torch.Tensor, percentile: float | None) -> float:
    """max of |x|, or its ``percentile`` with linear interpolation
    (``jnp.percentile``), by ``kthvalue``: ``torch.quantile`` refuses more
    than 2^24 elements."""
    a = a.detach().to(torch.float32).abs().flatten()
    if percentile is None:
        return float(a.max())
    pos = percentile / 100.0 * (a.numel() - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    vlo = float(a.kthvalue(lo + 1).values)
    vhi = vlo if hi == lo else float(a.kthvalue(hi + 1).values)
    w = pos - lo
    return float(np.float32(vlo * (1.0 - w) + vhi * w))


def _fused(model: nn.Module) -> bool:
    return isinstance(model, (DispResNet, DispVggBN)) and model.fused_upsample


def calibrate_conv_ranges(model: nn.Module, batches: Iterable[torch.Tensor],
                          exempt: Exempt = None, percentile: float | None = None
                          ) -> dict[str, float]:
    """One-shot activation-range calibration (JAX ``calibrate_conv_ranges``).

    An eval-mode forward over each (B, H, W, 3) batch, with forward hooks
    recording ``max |input|`` (or its ``percentile``) of every quantizable
    conv, ``max |output|`` of every ResNet block under ``<block>::out``, and,
    in a fused decoder, the two inputs of each fused stage (``h`` under the
    stage's key, the skip under ``<key>::skip``). Returns {flax path: range},
    the max over batches; raises ``ValueError`` for a range that is not
    positive and finite."""
    paths = flax_paths(model)
    fused = _fused(model)
    stats: dict[str, float] = {}

    def put(key: str, t: torch.Tensor) -> None:
        a = _reduce(t, percentile)
        stats[key] = max(stats[key], a) if key in stats else a

    modules = dict(model.named_modules())
    hooks = []
    for name, m in modules.items():
        key = paths.get(name)
        if key is None:
            continue
        if isinstance(m, (BasicBlock, Bottleneck)):
            hooks.append(m.register_forward_hook(
                lambda mod, args, out, key=key: put(key + "::out", out)))
        elif isinstance(m, UpProjection):
            for conv, sub in ((m.conv1, "conv_a"), (m.conv3, "conv_b")):
                if is_quantizable(conv, exempt):
                    hooks.append(m.register_forward_pre_hook(
                        lambda mod, args, key=f"{key}/{sub}": put(key, args[0])))
        elif is_quantizable(m, exempt) and not (fused and name.startswith("iconv")):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args, key=key: put(key, args[0])))
    if fused:
        stages = [i for i in range(5)
                  if not (exempt is not None and exempt(modules[f"iconv{i}.0"]))]

        def skips(mod, args, out):
            feats = out if isinstance(model, DispResNet) else out[0]
            for i in stages:
                if isinstance(model, DispVggBN):
                    put(paths[f"iconv{i}.0"] + "::skip", feats[i])
                elif i > 0:
                    put(paths[f"iconv{i}.0"] + "::skip", feats[i - 1])

        hooks.append(model.encoder.register_forward_hook(skips))
        for i in stages:
            hooks.append(modules[f"upconv{i}"].register_forward_hook(
                lambda mod, args, out, key=paths[f"iconv{i}.0"]: put(key, F.elu(out))))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for batch in batches:
                model(batch)
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    bad = [k for k, a in stats.items() if not (a > 0.0 and a == a)]
    if bad:
        raise ValueError(f"degenerate calibration ranges for {bad}")
    return stats


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def quant_kernel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float (Cout, kh, kw, Cin) -> (int8 weights, per-channel scale),
    ``w_scale = max(max|W|, 1e-12) / 127``, ``wq = round(W / w_scale)``."""
    w = w.detach().to(torch.float32)
    ws = _per127(torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12))
    return torch.round(w / ws[:, None, None, None]).to(torch.int8), ws


def _ohwi(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.detach().to(torch.float32).permute(0, 2, 3, 1)


def conv_eff(conv: nn.Conv2d, bn: nn.Module | None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(int8 weights, per-channel scale, bias) of ``conv`` with the eval-mode
    BN after it (None or the identity: none) folded in before quantizing
    (JAX ``_conv_eff``): a = gamma / sqrt(var + 1e-5), W * a,
    b = beta - a * mean."""
    w = _ohwi(conv)
    if bn is None or isinstance(bn, nn.Identity):
        b = (conv.bias.detach().to(torch.float32) if conv.bias is not None
             else torch.zeros(w.shape[0], device=w.device))
    else:
        a = bn.weight.detach().float() / sqrt_rn(bn.running_var.detach().float() + 1e-5)
        b = bn.bias.detach().float() - a * bn.running_mean.detach().float()
        w = w * a[:, None, None, None]
    wq, ws = quant_kernel(w)
    return wq, ws, b


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt correctly rounded (through float64, exact to round
    twice): the CPU's vectorized ``torch.sqrt`` can be an ulp off, numpy's
    and the card's are not."""
    return torch.sqrt(x.double()).float()


def compose_upsample_kernel_q(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (Cout, Cin, 6, 6) composed kernel, summed in the
    JAX ``compose_upsample_kernel``'s order (s, then t), so that its per-
    channel int8 grid is JAX's."""
    g = torch.tensor((0.25, 0.75, 0.75, 0.25), dtype=weight.dtype, device=weight.device)
    t2 = g[:, None] * g[None, :]
    kc = weight.new_zeros(*weight.shape[:2], 6, 6)
    for s in range(3):
        for t in range(3):
            kc = kc + F.pad(t2 * weight[:, :, s, t, None, None], (t, 2 - t, s, 2 - s))
    return kc


def _encoder_blocks(enc: ResNetEncoder):
    """(port block name, block) of a ResNet encoder, in order."""
    for s in range(1, 5):
        for b, block in enumerate(getattr(enc, f"layer{s}")):
            yield f"layer{s}.{b}", block


def _block_convs(block: nn.Module) -> list[tuple[str, nn.Conv2d, nn.Module]]:
    convs = [(f"conv{c}", getattr(block, f"conv{c}"), getattr(block, f"bn{c}"))
             for c in (1, 2, 3) if hasattr(block, f"conv{c}")]
    if block.downsample is not None:
        convs.append(("downsample.0", block.downsample[0], block.downsample[1]))
    return convs


def _encoder_prefix(model: nn.Module) -> str:
    return "" if isinstance(model, FCRN) else "encoder."


def _encoder_chain_keys(model: nn.Module, paths: dict[str, str]) -> list[str]:
    p = _encoder_prefix(model)
    enc = model if isinstance(model, FCRN) else model.encoder
    keys = [paths[p + "conv1"], paths[p + "layer1.0.conv1"]]
    for name, block in _encoder_blocks(enc):
        keys.append(paths[p + name] + "::out")
        keys += [paths[f"{p}{name}.conv{c}"] for c in (2, 3) if hasattr(block, f"conv{c}")]
    return keys


def _chain_ready(keys: list[str], ranges: dict, exempt: Exempt) -> bool:
    return exempt is None and all(k in ranges for k in keys)


def _fused_convs(model: nn.Module) -> set[str]:
    return {f"iconv{i}.0" for i in range(5)} if _fused(model) else set()


def bake_int8_weights(model: nn.Module, ranges: dict[str, float], exempt: Exempt = None
                      ) -> dict[str, tuple]:
    """Every weight the int8 path quantizes, quantized once (JAX
    ``bake_int8_weights``): ``{flax path: (wq, w_scale, bias or None)}`` for
    each calibrated quantizable conv but a fused decoder stage's, and
    ``{flax path + "::eff": (wq, w_scale, b_eff)}`` (BN folded in) for the
    convs of the chains that ``ranges`` enables. ``wq`` is (Cout, kh, kw,
    Cin) int8, the scales and biases (Cout,) float32."""
    paths = flax_paths(model)
    modules = dict(model.named_modules())
    baked: dict[str, tuple] = {}
    skip = _fused_convs(model)
    for name, m in modules.items():
        key = paths.get(name)
        if key in ranges and name not in skip and is_quantizable(m, exempt):
            wq, ws = quant_kernel(_ohwi(m))
            bias = None if m.bias is None else m.bias.detach().float().clone()
            baked[key] = (wq, ws, bias)
    if isinstance(model, (DispResNet, FCRN)) and _chain_ready(
            _encoder_chain_keys(model, paths), ranges, exempt):
        p = _encoder_prefix(model)
        enc = model if isinstance(model, FCRN) else model.encoder
        baked[paths[p + "conv1"] + "::eff"] = conv_eff(enc.conv1, enc.bn1)
        for name, block in _encoder_blocks(enc):
            for sub, conv, bn in _block_convs(block):
                baked[paths[f"{p}{name}.{sub}"] + "::eff"] = conv_eff(conv, bn)
    if isinstance(model, DispVggBN):
        for stage in _vgg_stages(model.encoder):
            if _chain_ready([paths[f"encoder.features.{i}"] for i, _, _ in stage], ranges,
                            exempt):
                for i, conv, bn in stage:
                    baked[paths[f"encoder.features.{i}"] + "::eff"] = conv_eff(conv, bn)
    if isinstance(model, DispNetS):
        for n in range(1, 8):
            block = getattr(model, f"conv{n}")
            keys = [paths[f"conv{n}.0"], paths[f"conv{n}.2"]]
            if _chain_ready(keys, ranges, exempt):
                baked[keys[0] + "::eff"] = conv_eff(block[0], None)
                baked[keys[1] + "::eff"] = conv_eff(block[2], None)
    return baked


def _vgg_stages(enc: VggEncoder) -> list[list[tuple[int, nn.Conv2d, nn.Module]]]:
    """Each stage's (features index, conv, BN), up to its pool."""
    stages, start = [], 0
    for pool in enc.pools:
        stages.append([(i, enc.features[i], enc.features[i + 1])
                       for i in range(start, pool, 3)])
        start = pool + 1
    return stages


# ---------------------------------------------------------------------------
# the int8 modules
# ---------------------------------------------------------------------------


class _QWeights(nn.Module):
    """An int8 conv weight packed once for its geometry (``pack_weight``:
    Cin padded to a multiple of 16, an lhs-dilated conv's phases apart),
    with its scale, bias, geometry and true input channels ``cin``."""

    def __init__(self, entry: tuple, geom: Geometry):
        super().__init__()
        wq, ws, bias = entry
        self.geom = geom
        self.cin = wq.shape[3]
        self.register_buffer("w", pack_weight(wq.contiguous(), geom))
        self.register_buffer("ws", ws.detach().float().clone())
        self.register_buffer("bias", torch.zeros_like(self.ws) if bias is None
                             else bias.detach().float().clone())

    def run(self, xq: torch.Tensor, mult: torch.Tensor, **kw) -> torch.Tensor:
        return int8_conv(xq, self.w, self.geom, mult, self.bias, **kw)


def _geometry(conv: nn.Conv2d) -> Geometry:
    ph, pw = conv.padding
    return Geometry(*conv.kernel_size, tuple(conv.stride), (ph, ph, pw, pw), (1, 1),
                    tuple(conv.dilation))


class QConv2d(nn.Module):
    """A calibrated conv in int8 (JAX ``_int8_conv``): NCHW float input,
    quantized with its range's scale; the int8 conv; out ``float(acc) *
    in_scale * w_scale + bias`` in the input's dtype, NCHW."""

    def __init__(self, entry: tuple, geom: Geometry, in_range: float):
        super().__init__()
        self.q = _QWeights(entry, geom)
        s = scale_of(in_range)
        self.register_buffer("s_in", torch.tensor(s, dtype=torch.float32))
        self.register_buffer("mult", torch.tensor(s, dtype=torch.float32) * self.q.ws)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.q.run(quantize(_nhwc(x), self.s_in), self.mult)
        return _nchw(y).to(x.dtype)


class QFusedUpConv(nn.Module):
    """A fused decoder stage in int8 (JAX ``_int8_fused_upconv``): the
    composed 6x6 kernel, quantized per output channel, over the edge-padded
    int8 half-resolution input dilated by 2; the 1-pixel border corrections
    in float on its dequantized values; the skip a second int8 conv (its
    epilogue adds the corrected main conv's float32 output, then the bias)."""

    def __init__(self, conv: nn.Conv2d, h_range: float, skip_range: float | None):
        super().__init__()
        w = conv.weight.detach().float()
        ch = conv.out_channels  # h has the stage's width; the skip the rest
        kh = w[:, :ch]
        self.register_buffer("kh", kh.clone())  # the border corrections' taps
        wcq, wcs = quant_kernel(compose_upsample_kernel_q(kh).permute(0, 2, 3, 1))
        bias = conv.bias.detach().float()
        self.main = _QWeights((wcq, wcs, None), FUSED_GEOMETRY)
        s = scale_of(h_range)
        self.register_buffer("s_h", torch.tensor(s, dtype=torch.float32))
        self.register_buffer("mult", torch.tensor(s, dtype=torch.float32) * wcs)
        self.register_buffer("b", bias.clone())
        self.skip = None
        if skip_range is not None:
            self.skip = _QWeights((*quant_kernel(w[:, ch:].permute(0, 2, 3, 1)), bias),
                                  Geometry.square(3, 1, 1))
            ss = scale_of(skip_range)
            self.register_buffer("s_skip", torch.tensor(ss, dtype=torch.float32))
            self.register_buffer("mult_skip", torch.tensor(ss, dtype=torch.float32)
                                 * self.skip.ws)

    def stage(self, hq: torch.Tensor, skip: torch.Tensor | None, act: str = "none",
              out_scale: float | None = None) -> torch.Tensor:
        """int8 NHWC ``hq`` (scale ``s_h``) and float NHWC ``skip`` -> the
        stage's NHWC output with ``act``: float32, or int8 at ``out_scale``."""
        y = self.main.run(edge_pad(hq), self.mult)
        rows, cols = border_corrections(_nchw(dequant(hq, self.s_h)), self.kh)
        y[:, 0] -= rows[:, 0].transpose(1, 2)
        y[:, -1] -= rows[:, 1].transpose(1, 2)
        y[:, :, 0] -= cols[:, 0].transpose(1, 2)
        y[:, :, -1] -= cols[:, 1].transpose(1, 2)
        if self.skip is None:
            y = y + self.b
            y = F.elu(y) if act == "elu" else y
            return y if out_scale is None else quantize(y, _t(out_scale, y.device))
        out = "f32" if out_scale is None else "s8"
        return self.skip.run(quantize(skip, self.s_skip), self.mult_skip, residual=y,
                             res_before_bias=True, act=act, out=out,
                             out_scale=1.0 if out_scale is None else out_scale)

    def forward(self, h: torch.Tensor, skip: torch.Tensor | None) -> torch.Tensor:
        """The per-stage path: NCHW float in, NCHW float32 out, before the
        activation."""
        y = self.stage(quantize(_nhwc(h), self.s_h), None if skip is None else _nhwc(skip))
        return _nchw(y).to(h.dtype)


class BF16DispHead(nn.Module):
    """The disparity head of the int8 path (JAX ``_bf16_disp_head``): the
    3x3 conv in bf16 (input and weight rounded to bf16), the bias, sigmoid
    and scale in float32."""

    def __init__(self, head: DispHead):
        super().__init__()
        conv = head[0]
        self.register_buffer("w", conv.weight.detach().to(torch.bfloat16).clone())
        self.register_buffer("b", conv.bias.detach().float().clone())
        self.alpha, self.beta = head.alpha, head.beta

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(torch.bfloat16), self.w, padding=1).to(torch.float32)
        return self.alpha * torch.sigmoid(y + self.b[:, None, None]) + self.beta


class Int8ResNetEncoder(nn.Module):
    """The ResNet encoder int8 end to end (JAX ``_int8_chain_encoder``):
    NCHW float input -> the five float32 feature maps, NCHW. Between convs
    activations are int8; each block's output is requantized with its
    ``::out`` range."""

    def __init__(self, enc: ResNetEncoder, key: Callable[[str], str], baked: dict,
                 ranges: dict):
        super().__init__()
        eff = lambda name: baked[key(name) + "::eff"]  # noqa: E731
        self.stem = _QWeights(eff("conv1"), _geometry(enc.conv1))
        self.register_buffer("s_in", _t(scale_of(ranges[key("conv1")]), "cpu"))
        # the stem's output scale: the first block's input range (the max
        # pool keeps the max)
        self.s_stem = scale_of(ranges[key("layer1.0.conv1")])
        plan, scales = [], []
        self.blocks = nn.ModuleList()
        for name, block in _encoder_blocks(enc):
            convs = nn.ModuleDict()
            for sub, conv, _ in _block_convs(block):
                convs[sub.replace(".", "_")] = _QWeights(eff(f"{name}.{sub}"), _geometry(conv))
            self.blocks.append(convs)
            mids = [scale_of(ranges[key(f"{name}.conv{c}")]) for c in (2, 3)
                    if hasattr(block, f"conv{c}")]
            plan.append((isinstance(block, Bottleneck), block.downsample is not None,
                         name.endswith(f".{len(getattr(enc, name.split('.')[0])) - 1}")))
            scales.append((mids, scale_of(ranges[key(name) + "::out"])))
        self.plan = plan
        self.scales = scales

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        dev = x.device
        s_in = self.s_in
        s_h = self.s_stem
        hq = self.stem.run(quantize(_nhwc(x), s_in), s_in * self.stem.ws, act="relu",
                           out="s8", out_scale=s_h)
        feats = [dequant(hq, _t(s_h, dev))]
        hq = maxpool_q(hq)
        for convs, (bottleneck, has_ds, last), (mids, s_o) in zip(
                self.blocks, self.plan, self.scales):
            t_h = _t(s_h, dev)
            h = hq
            scale = t_h
            names = ["conv1", "conv2", "conv3"] if bottleneck else ["conv1", "conv2"]
            for name, s_next in zip(names[:-1], mids):
                h = convs[name].run(h, scale * convs[name].ws, act="relu", out="s8",
                                    out_scale=s_next)
                scale = _t(s_next, dev)
            last_conv = convs[names[-1]]
            if has_ds:
                ds = convs["downsample_0"]
                idn = ds.run(hq, t_h * ds.ws, out="bf16")
                hq = last_conv.run(h, scale * last_conv.ws, residual=idn, act="relu",
                                   out="s8", out_scale=s_o)
            else:
                hq = last_conv.run(h, scale * last_conv.ws, residual=hq, res_scale=s_h,
                                   act="relu", out="s8", out_scale=s_o)
            s_h = s_o
            if last:
                feats.append(dequant(hq, _t(s_h, dev)))
        return [_nchw(f) for f in feats]


class Int8VggEncoder(nn.Module):
    """VGG-BN's encoder with each stage int8 inside (JAX
    ``_int8_chain_vgg_stage``): the stage's input quantized, each conv's
    epilogue BN-folded + ReLU + requantized to the next conv's range, the
    last one float32 (a decoder skip). Returns (skips, bottleneck) as
    ``VggEncoder``."""

    def __init__(self, enc: VggEncoder, paths: dict, baked: dict, ranges: dict):
        super().__init__()
        self.stages = nn.ModuleList()
        self.scales = []
        for stage in _vgg_stages(enc):
            keys = [paths[f"encoder.features.{i}"] for i, _, _ in stage]
            self.stages.append(nn.ModuleList(
                _QWeights(baked[k + "::eff"], _geometry(conv))
                for k, (_, conv, _) in zip(keys, stage)))
            self.scales.append([scale_of(ranges[k]) for k in keys])
        # the stages' input scales on the device: a quantize divides by one
        self.register_buffer("s_in", torch.tensor([s[0] for s in self.scales]))

    def forward(self, x: torch.Tensor) -> tuple[list[torch.Tensor], torch.Tensor]:
        skips, h = [], _nhwc(x)
        for j, (convs, scales) in enumerate(zip(self.stages, self.scales)):
            s = self.s_in[j]
            q = quantize(h, s)
            for i, conv in enumerate(convs):
                if i < len(convs) - 1:
                    q = conv.run(q, s * conv.ws, act="relu", out="s8", out_scale=scales[i + 1])
                    s = _t(scales[i + 1], x.device)
                else:
                    y = conv.run(q, s * conv.ws, act="relu")
            skips.append(_nchw(y))
            h = _nhwc(F.max_pool2d(_nchw(y), 2, 2))
        return skips, _nchw(h)


class Int8DownsampleConv(nn.Module):
    """DispNetS's ``DownsampleConv`` int8 inside (JAX
    ``_int8_chain_downsample``): conv_a's epilogue bias + ELU + requantize to
    conv_b's range; conv_b's float32 + ELU (an encoder skip)."""

    def __init__(self, block: DownsampleConv, keys: list[str], baked: dict, ranges: dict):
        super().__init__()
        self.a = _QWeights(baked[keys[0] + "::eff"], _geometry(block[0]))
        self.b = _QWeights(baked[keys[1] + "::eff"], _geometry(block[2]))
        self.s_b = scale_of(ranges[keys[1]])
        sa = torch.tensor(scale_of(ranges[keys[0]]))
        self.register_buffer("s_a", sa)
        self.register_buffer("mult_a", sa * self.a.ws)
        self.register_buffer("mult_b", torch.tensor(self.s_b) * self.b.ws)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.a.run(quantize(_nhwc(x), self.s_a), self.mult_a, act="elu", out="s8",
                       out_scale=self.s_b)
        return _nchw(self.b.run(q, self.mult_b, act="elu")).to(x.dtype)


def _set(root: nn.Module, name: str, module: nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, leaf, module)


def _decoder_chain_keys() -> list[str]:
    """The keys of the DispResNet decoder chain (JAX ``_decoder_chain_keys``)."""
    keys = []
    for i in range(5):
        keys += [f"upconv{i}_0/Conv_0", f"upconv{i}_1/Conv_0"]
        if i > 0:
            keys.append(f"upconv{i}_1/Conv_0::skip")
    return keys


def decoder_chain_ready(model: nn.Module, ranges: dict) -> bool:
    """JAX ``_decoder_chain_ready``: a fused DispResNet whose calibration
    has every key of the chain."""
    return (isinstance(model, DispResNet) and model.fused_upsample
            and all(k in ranges for k in _decoder_chain_keys()))


class QuantizedModel(nn.Module):
    """The eval-only int8 twin of a registry network (module docstring).
    ``forward(x)`` takes (B, H, W, 3) and returns what the network returns.
    ``n_int8_convs`` is the number of int8 convolutions a forward runs;
    ``encoder_chain`` and ``dec_chain`` say which chains it takes."""

    def __init__(self, model: nn.Module, ranges: dict[str, float], exempt: Exempt = None,
                 baked: dict | None = None):
        super().__init__()
        if baked is None:
            baked = bake_int8_weights(model, ranges, exempt)
        paths = flax_paths(model)
        self.ranges = dict(ranges)
        net = copy.deepcopy(model).eval()
        fused = _fused_convs(model)
        chained: set[str] = set()
        self.encoder_chain = False
        self.fcrn_encoder = None
        n = 0
        if isinstance(model, (DispResNet, FCRN)) and _chain_ready(
                _encoder_chain_keys(model, paths), ranges, exempt):
            p = _encoder_prefix(model)
            enc = model if isinstance(model, FCRN) else model.encoder
            chain = Int8ResNetEncoder(enc, lambda s: paths[p + s], baked, ranges)
            self.encoder_chain = True
            n += sum(len(c) for c in chain.blocks) + 1
            if isinstance(model, FCRN):
                self.fcrn_encoder = chain
                for name in ("conv1", "bn1", "layer1", "layer2", "layer3", "layer4"):
                    delattr(net, name)
            else:
                net.encoder = chain
            chained |= {k for k in paths if k.startswith(p + "conv1") or k.startswith(p + "layer")}
        if isinstance(model, DispVggBN) and all(
                _chain_ready([paths[f"encoder.features.{i}"] for i, _, _ in stage], ranges,
                             exempt) for stage in _vgg_stages(model.encoder)):
            net.encoder = Int8VggEncoder(model.encoder, paths, baked, ranges)
            n += sum(len(s) for s in net.encoder.stages)
            chained |= {k for k in paths if k.startswith("encoder.")}
        if isinstance(model, DispNetS):
            for i in range(1, 8):
                keys = [paths[f"conv{i}.0"], paths[f"conv{i}.2"]]
                if _chain_ready(keys, ranges, exempt):
                    _set(net, f"conv{i}", Int8DownsampleConv(
                        getattr(model, f"conv{i}"), keys, baked, ranges))
                    n += 2
                    chained |= {f"conv{i}.0", f"conv{i}.2"}
        modules = dict(model.named_modules())
        for name, m in modules.items():
            key = paths.get(name)
            if isinstance(m, DispHead) and exempt is None and ranges:
                _set(net, name, BF16DispHead(m))
            if key is None or name in chained:
                continue
            if name in fused:
                skip_key = key + "::skip"
                has_skip = name != "iconv0.0" or isinstance(model, DispVggBN)
                if (key in ranges and (not has_skip or skip_key in ranges)
                        and not (exempt is not None and exempt(m))):
                    _set(net, name, QFusedUpConv(m, ranges[key],
                                                 ranges[skip_key] if has_skip else None))
                    n += 2 if has_skip else 1
            elif key in ranges and is_quantizable(m, exempt):
                geom = (UNPOOL_GEOMETRY if isinstance(model, FCRN)
                        and name.endswith((".conv1", ".conv3")) and name.startswith("up")
                        else _geometry(m))
                _set(net, name, QConv2d(baked[key], geom, ranges[key]))
                n += 1
        self.net = net
        self.dec_chain = exempt is None and decoder_chain_ready(model, ranges)
        self.n_int8_convs = n

    def forward(self, x: torch.Tensor):
        if self.fcrn_encoder is not None:
            h = self.fcrn_encoder(_nchw(x))[-1]
            return self.net.decode(h, x.shape[1], x.shape[2])
        if self.dec_chain:
            return self._dispresnet_chain(x)
        return self.net(x)

    def _dispresnet_chain(self, x: torch.Tensor):
        """DispResNet with the int8 decoder chain (JAX
        ``_int8_chain_dec_conv`` / ``_int8_chain_dec_fused``): each
        upconv{i}_0 requantizes (ELU in its epilogue) to the fused stage's
        input range, each fused stage to the next upconv's; the last stage
        returns float32 for the head."""
        net, r = self.net, self.ranges
        enc = [_nhwc(f) for f in net.encoder(_nchw(x))]
        up = net.upconv4[0]
        act = QAct(quantize(enc[-1], up.s_in), up.s_in)
        feats = {}
        for i in range(4, -1, -1):
            up, stage = getattr(net, f"upconv{i}")[0], getattr(net, f"iconv{i}")[0]
            s_mid = scale_of(r[f"upconv{i}_1/Conv_0"])
            hq = up.q.run(act.q, act.scale * up.q.ws, act="elu", out="s8", out_scale=s_mid)
            if i > 0:
                s_next = scale_of(r[f"upconv{i - 1}_0/Conv_0"])
                q = stage.stage(hq, enc[i - 1], act="elu", out_scale=s_next)
                act = feats[i] = QAct(q, _t(s_next, x.device))
            else:
                feats[0] = stage.stage(hq, None, act="elu")
        dense = {s: (f.dequant() if isinstance(f, QAct) else f) for s, f in feats.items()}
        if net.head == "classification":
            logits = [getattr(net, _class_head(s))(_nchw(dense[s])).permute(0, 2, 3, 1)
                      for s in range(4 if net.multiscale_classification else 1)]
            return logits if net.multiscale_classification else logits[0]
        return [getattr(net, f"predict_disp{s + 1}")(_nchw(dense[s])).permute(0, 2, 3, 1)
                for s in range(4)]


def _class_head(s: int) -> str:
    return "predict_class" if s == 0 else f"predict_class{s + 1}"


def quantized_apply(model: nn.Module, x: torch.Tensor, *, ranges: dict[str, float],
                    exempt: Exempt = None, baked: dict | None = None):
    """Eval-mode forward of ``model`` with every calibrated conv in int8
    (JAX ``quantized_apply``): builds the int8 twin and runs it on ``x``
    without gradients. Empty ``ranges`` give the float forward. ``baked``
    (``bake_int8_weights``) supplies the quantized weights."""
    twin = QuantizedModel(model, ranges, exempt=exempt, baked=baked)
    with torch.no_grad():
        return twin(x)


# ---------------------------------------------------------------------------
# quantization-aware training
# ---------------------------------------------------------------------------


def qdq_ste(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantize-dequantize with a straight-through gradient
    (JAX ``_qdq_ste``): forward ``clip(round(x / s), -127, 127) * s``,
    backward the identity."""
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0) * scale
    return x + (q - x).detach()


def _tensor_scale(x: torch.Tensor) -> torch.Tensor:
    """max|x| / 127; on a data-parallel mesh the global batch's max, as the
    JAX mesh takes it."""
    return _per127(torch.clamp_min(all_reduce_max(x.detach().abs().amax()), 1e-12))


def _channel_scale(w: torch.Tensor) -> torch.Tensor:
    """Per output channel of an OIHW kernel, broadcastable against it."""
    return _per127(torch.clamp_min(w.detach().abs().amax(dim=(1, 2, 3)), 1e-12)
                   )[:, None, None, None]


def _qdq_weight(w: torch.Tensor) -> torch.Tensor:
    return qdq_ste(w, _channel_scale(w))


def _qdq_input(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    return qdq_ste(xf, _tensor_scale(xf))


class _FakeQuant:
    """The QAT context (``fake_quant_methods``): which convs it takes, and
    their fake-quantized forwards, all in float32 and returning the input's
    dtype (JAX ``_fake_quant_conv``, ``_fake_quant_fused_upconv``)."""

    def __init__(self, exempt: Exempt):
        self.exempt = exempt

    def applies(self, conv: nn.Module) -> bool:
        return is_quantizable(conv, self.exempt)

    def conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(_qdq_input(x), _qdq_weight(conv.weight.float()), None, conv.stride,
                     conv.padding, conv.dilation)
        if conv.bias is not None:
            y = y + conv.bias.float()[:, None, None]
        return y.to(x.dtype)

    def unpool(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        w = _qdq_weight(conv.weight.float()).flip(2, 3).transpose(0, 1)
        y = F.conv_transpose2d(_qdq_input(x), w, None, stride=2, padding=2, output_padding=1)
        return (y + conv.bias.float()[:, None, None]).to(x.dtype)

    def fused(self, conv: nn.Conv2d, h: torch.Tensor, skip: torch.Tensor | None
              ) -> torch.Tensor:
        """The fused stage with the int8 stage's QDQ noise: the composed 6x6
        kernel quantize-dequantized per output channel, ``h`` and ``skip``
        with scales of their own, the border corrections in float on the
        QDQ'd input."""
        w = conv.weight.float()
        ch = h.shape[1]
        kh, ks = w[:, :ch], w[:, ch:]
        kc = compose_upsample_kernel_q(kh)
        y = upconv2x_fused(_qdq_input(h), kh, composed_kernel=_qdq_weight(kc))
        if skip is not None:
            y = y + F.conv2d(_qdq_input(skip), _qdq_weight(ks), padding=1)
        return (y + conv.bias.float()[:, None, None]).to(h.dtype)


@contextlib.contextmanager
def fake_quant_methods(exempt: Exempt = None):
    """QAT forwards: inside the context every quantizable conv (the serving
    path's predicate; ``exempt`` convs excepted) runs fake-quantized and the
    fused decoder stages run the QDQ mirror of the int8 stage::

        with fake_quant_methods():
            out = model(x)
    """
    token = FAKE_QUANT.set(_FakeQuant(exempt))
    try:
        yield
    finally:
        FAKE_QUANT.reset(token)


__all__ = ["BF16DispHead", "QAct", "QConv2d", "QFusedUpConv", "QuantizedModel",
           "bake_int8_weights", "calibrate_conv_ranges", "decoder_chain_ready",
           "fake_quant_methods", "is_quantizable", "qdq_ste", "quantized_apply"]
