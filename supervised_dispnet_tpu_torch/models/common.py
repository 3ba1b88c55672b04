"""Shared model building blocks: the conv+ELU blocks, the disparity head,
flax-matched BatchNorm, the initialisers, the compute dtype and activation
checkpointing. The port of ``supervised_dispnet_tpu/models/common.py``
(NCHW inside the modules).

**Quantization.** Inside ``ops/quant.py::fake_quant_methods`` (QAT) every
quantizable conv runs fake-quantized: the trunk ``Conv2d``, ``FloatConv2d``
(a float32 conv outside the trunk's compute dtype), the fused decoder stage
(``fused_upsample_conv``) and FCRN's unpool conv read ``FAKE_QUANT``. The
int8 twin of a model (``ops/quant.py::QuantizedModel``) puts its own modules
where ``fused_upsample_conv`` and FCRN's unpool conv take a conv.

The blocks are ``nn.Sequential``s so that their layers carry the reference
state dict's names (``conv{i}.0`` / ``.2``, ``upconv{i}.0``, ``iconv{i}.0``).

**Compute dtype.** flax's ``dtype`` field (``--bf16``) is cast explicitly,
where flax casts, not with ``torch.autocast`` (whose op lists differ between
the CPU and CUDA): a trunk ``Conv2d`` / ``ConvTranspose2d`` with
``compute_dtype`` set computes in it from its input, weight and bias cast to
it, and adds the bias to its rounded output; ``BatchNorm2d`` takes its
statistics and normalises in float32 and returns the compute dtype. The
heads are ``FloatConv2d``s that run in float32. Parameters stay float32
throughout, so their gradients do too.

**Spatial partitioning.** The trunk convs, ``FloatConv2d`` (the heads, FCRN)
and the transposed convs run their window over this rank's rows with the
halo rows of its neighbours (``parallel/spatial.py``) inside a step on a mesh
with a spatial axis; so do ``crop_like`` and the fused decoder stage.
Train-mode BatchNorm takes its statistics over the whole mesh then.

**Remat.** ``remat_call`` runs a block under ``torch.utils.checkpoint``:
``"full"`` saves nothing of it, ``"conv"`` saves the convolutions' (and
matrix products') outputs and recomputes the rest, as the JAX package's
``remat_wrap`` policies do. A block's train-mode BatchNorms update their
running statistics once, in the forward, not again when the backward
recomputes it."""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from supervised_dispnet_tpu_torch.ops.fused_upconv import upconv2x_fused
from supervised_dispnet_tpu_torch.parallel import spatial
from supervised_dispnet_tpu_torch.parallel.mesh import active_mesh, all_reduce_sum

# Disparity head output scaling (reference: DispNetS alpha/beta constants).
DISP_ALPHA = 10.0
DISP_BETA = 0.01


def xavier_uniform_(conv: nn.Conv2d | nn.ConvTranspose2d,
                    generator: torch.Generator | None) -> None:
    """flax ``xavier_uniform`` kernel, zero bias (flax ``nn.Conv`` defaults).
    The bound depends on fan_in + fan_out only, so a transposed conv's
    (I, O, kh, kw) weight gets flax's bound too."""
    nn.init.xavier_uniform_(conv.weight, generator=generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)


def init_convs_xavier_(module: nn.Module, generator: torch.Generator | None) -> None:
    """xavier-uniform, zero-bias init of every (transposed) conv of ``module``,
    in ``named_modules`` order."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            xavier_uniform_(m, generator)


def _add_bias(y: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """flax's conv epilogue in a compute dtype: the bias added to the conv's
    rounded output (cuDNN adds it so too; the CPU's fused bias would round
    once)."""
    return y if bias is None else y + bias[:, None, None]


# the QAT context of ops/quant.py::fake_quant_methods, None outside it
FAKE_QUANT: contextvars.ContextVar = contextvars.ContextVar("FAKE_QUANT", default=None)


def fake_quant_context(conv: nn.Module):
    """The active QAT context when it fake-quantizes ``conv``, else None."""
    fq = FAKE_QUANT.get()
    return fq if fq is not None and fq.applies(conv) else None


class _ComputeParams:
    """A trunk conv's ``compute_dtype`` (None: float32) and its weight and
    bias in it."""

    compute_dtype: torch.dtype | None = None

    def compute_params(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        dt = self.compute_dtype
        if dt is None:
            return self.weight, self.bias
        return self.weight.to(dt), None if self.bias is None else self.bias.to(dt)


class _RowConv:
    """An ``nn.Conv2d`` whose window runs over this rank's rows and its
    neighbours' halo rows under spatial partitioning (the plain conv
    otherwise)."""

    def _conv_forward(self, x, weight, bias):
        return spatial.conv2d(x, weight, bias, self.stride, self.padding, self.dilation,
                              self.groups)


class Conv2d(_RowConv, _ComputeParams, nn.Conv2d):
    """A trunk conv: ``nn.Conv2d`` that, with ``compute_dtype`` set, computes
    in it (flax ``nn.Conv(dtype=)``). Its state dict is ``nn.Conv2d``'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fq = fake_quant_context(self)
        if fq is not None:
            return fq.conv(self, x)
        if self.compute_dtype is None:
            return super().forward(x)
        weight, bias = self.compute_params()
        return _add_bias(self._conv_forward(x.to(self.compute_dtype), weight, None), bias)


class FloatConv2d(_RowConv, nn.Conv2d):
    """A float32 conv outside the trunk's compute dtype (the disparity and
    bin-logit heads, FCRN) that QAT fake-quantizes (all but the one-channel
    disparity heads). Its state dict is ``nn.Conv2d``'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fq = fake_quant_context(self)
        return fq.conv(self, x) if fq is not None else super().forward(x)


class ConvTranspose2d(_ComputeParams, nn.ConvTranspose2d):
    """A trunk transposed conv with ``compute_dtype``, as ``Conv2d``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None and spatial.active() is None:
            return super().forward(x)
        weight, bias = self.compute_params()
        if self.compute_dtype is None:
            return spatial.conv_transpose2d(x, weight, bias, self.stride, self.padding,
                                            self.output_padding, self.groups, self.dilation)
        y = spatial.conv_transpose2d(x.to(self.compute_dtype), weight, None, self.stride,
                                     self.padding, self.output_padding, self.groups,
                                     self.dilation)
        return _add_bias(y, bias)


class ConvELU(nn.Sequential):
    """k x k conv (padding (k-1)/2, optional stride) + ELU."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__(Conv2d(in_channels, out_channels, kernel, stride=stride,
                                padding=(kernel - 1) // 2), nn.ELU())


class DownsampleConv(nn.Sequential):
    """stride-2 conv + ELU, then stride-1 conv + ELU (reference
    ``downsample_conv``: layers ``0`` and ``2``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3):
        pad = (kernel - 1) // 2
        super().__init__(
            Conv2d(in_channels, out_channels, kernel, stride=2, padding=pad), nn.ELU(),
            Conv2d(out_channels, out_channels, kernel, padding=pad), nn.ELU())


class UpConvELU(nn.Sequential):
    """2x transposed-conv upsample + ELU: ``ConvTranspose2d(k=3, stride=2,
    padding=1, output_padding=1)``, which is what the JAX package's
    ``nn.ConvTranspose(padding=((1, 2), (1, 2)))`` with a spatially flipped
    kernel computes. The output is exactly twice the input."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(ConvTranspose2d(in_channels, out_channels, 3, stride=2,
                                         padding=1, output_padding=1), nn.ELU())


def crop_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Crop NCHW ``x`` to ``ref``'s height and width (a transposed conv
    overshoots odd sizes by one); under spatial partitioning only the shard
    at the image's bottom may lose rows."""
    return spatial.crop_rows_like(x, ref)


def kaiming_normal_(conv: nn.Conv2d, generator: torch.Generator | None) -> None:
    """flax ``kaiming_normal``: truncated normal at +-2 sigma, fan-in scaled so
    the truncated distribution has variance 2 / fan_in."""
    fan_in = conv.weight[0].numel()
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)


# True while torch.utils.checkpoint recomputes a block in the backward (in
# the thread that recomputes it)
_RECOMPUTING: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "_RECOMPUTING", default=False)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``
    semantics. ``torch.nn.BatchNorm2d`` updates ``running_var`` with the
    unbiased batch variance; flax (and so the JAX package) uses the biased
    one, which this module does. Normalisation in train mode uses the biased
    batch variance in both. State-dict layout is torch's. The batch
    variance is two-pass, the mean of the squared deviations from the mean,
    on one process and on a mesh (ROADMAP C12): flax's fast variance,
    E[x^2] - E[x]^2, is not copied.

    With ``compute_dtype`` set (flax's ``dtype``), statistics and
    normalisation are float32 and the output is ``compute_dtype``. A
    recomputation under ``remat_call`` leaves the running statistics as the
    forward left them."""

    compute_dtype: torch.dtype | None = None

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a bf16 input normalises in float32 inside F.batch_norm (float32
        # weight and bias) and comes back bf16: flax's rounding points
        if not self.training:
            y = super().forward(x)
        elif (mesh := active_mesh()) is not None:
            y = self._global_batch_norm(x, mesh)
        else:
            if not _RECOMPUTING.get():
                with torch.no_grad():
                    var, mean = torch.var_mean(x.to(torch.float32), dim=(0, 2, 3),
                                               unbiased=False)
                    self.running_mean.lerp_(mean, self.momentum)
                    self.running_var.lerp_(var, self.momentum)
                    self.num_batches_tracked += 1
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y if self.compute_dtype is None else y.to(self.compute_dtype)

    def _global_batch_norm(self, x: torch.Tensor, mesh) -> torch.Tensor:
        """Train mode on a mesh: the statistics of every rank's rows, as
        exact as the one-process path's two-pass ones (ROADMAP C12), from
        one all-reduce. Each rank puts its rows' sums, count, and sums of
        squared deviations from its own mean into its slot of a (ranks,
        2C + 1) table, and the all-reduce fills in the other ranks' slots.
        The global mean is the sums' sum over the count; Chan's formula
        gives the global sum of squared deviations: the ranks' own plus
        each count times its mean's squared distance from the global mean.
        flax's fast variance, E[x^2] - E[x]^2 in float32, loses the
        variance of a channel whose mean is far above its spread (1e3 +- 1:
        3.31 for 0.989 in flax, PERF.md section 7). The gradient flows
        through the table to every rank's rows."""
        xf = x.to(torch.float32)
        C = x.shape[1]
        n_local = xf.numel() // C
        sums = xf.sum(dim=(0, 2, 3))
        mean_local = sums / n_local
        dev = xf - mean_local[:, None, None]
        count = torch.full((1,), float(n_local), dtype=torch.float32, device=x.device)
        mine = torch.cat([sums, (dev * dev).sum(dim=(0, 2, 3)), count])
        slots = [torch.zeros_like(mine)] * mesh.size
        slots[mesh.rank] = mine
        table = all_reduce_sum(torch.stack(slots))
        counts = table[:, 2 * C:]
        n = counts.sum()
        mean = table[:, :C].sum(dim=0) / n
        spread = counts * (table[:, :C] / counts.clamp(min=1.0) - mean) ** 2
        var = (table[:, C:2 * C].sum(dim=0) + spread.sum(dim=0)) / n
        if not _RECOMPUTING.get():
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
                self.num_batches_tracked += 1
        scale = torch.rsqrt(var + self.eps) * self.weight
        # from the deviations already kept for the backward: x - mean is
        # (x - this rank's mean) + (this rank's mean - mean), and the
        # autograd graph holds one activation-sized tensor, not two
        shift = (mean_local - mean) * scale + self.bias
        y = dev * scale[:, None, None] + shift[:, None, None]
        return y.to(x.dtype)


def set_compute_dtype(model: nn.Module, dtype: torch.dtype | None) -> bool:
    """Make ``model``'s trunk compute in ``dtype`` (None: float32), as the
    JAX trainer's ``model.clone(dtype=...)`` does, on the networks that have
    that field (``has_compute_dtype``): every ``Conv2d``, ``ConvTranspose2d``
    and ``BatchNorm2d`` of it; the heads stay float32. Returns False, and
    changes nothing, for a network without the field (FCRN, as in the JAX
    package)."""
    if not getattr(model, "has_compute_dtype", False):
        return False
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, BatchNorm2d)):
            m.compute_dtype = dtype
    return True


# the ops whose outputs remat="conv" saves (jax.checkpoint's
# conv_general_dilated and dot_general)
_SAVED_OPS = frozenset((torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
                        torch.ops.aten.bmm.default, torch.ops.aten.addmm.default))


def _save_convs(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _recomputing(inner: contextlib.AbstractContextManager, fake_quant):
    """The recomputation's context: ``inner``, flagged as recomputing, under
    the QAT context the forward ran in (the backward runs outside it)."""
    token = _RECOMPUTING.set(True)
    fq_token = FAKE_QUANT.set(fake_quant)
    try:
        with inner:
            yield
    finally:
        FAKE_QUANT.reset(fq_token)
        _RECOMPUTING.reset(token)


def _contexts(policy: str):
    fwd, rec = ((contextlib.nullcontext(), contextlib.nullcontext()) if policy == "full"
                else create_selective_checkpoint_contexts(_save_convs))
    return fwd, _recomputing(rec, FAKE_QUANT.get())


def remat_policy(remat: bool | str | None) -> str | None:
    """The JAX package's ``remat`` values: falsy -> None, True or "full" ->
    "full", "conv" -> "conv"."""
    if not remat:
        return None
    if remat is True or remat == "full":
        return "full"
    if remat == "conv":
        return "conv"
    raise ValueError(f"unknown remat {remat!r}; choices: 'full', 'conv'")


def set_remat(model: nn.Module, remat: bool | str | None) -> None:
    """Checkpoint ``model``'s stages under ``remat`` (``remat_policy``'s
    values; falsy turns it off): every submodule with a ``remat`` attribute
    (the ResNet and VGG encoders' blocks or stages, DispNetS's stages,
    FCRN's up-projections) takes the policy."""
    policy = remat_policy(remat)
    for m in model.modules():
        if hasattr(m, "remat"):
            m.remat = policy


def remat_call(policy: str | None, fn, *args):
    """``fn(*args)``, checkpointed under ``policy`` ("full" or "conv") when
    gradients are being recorded; called as it is otherwise."""
    if policy is None or not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=functools.partial(_contexts, policy))


class DispHead(nn.Sequential):
    """3x3 conv -> sigmoid -> alpha * s + beta disparity head, always in
    float32 (disparity feeds 1/d and the losses). A ``Sequential`` so its conv
    is named ``0``, as in the reference state dict (``predict_disp{s}.0``)."""

    def __init__(self, in_channels: int, alpha: float = DISP_ALPHA,
                 beta: float = DISP_BETA):
        super().__init__(FloatConv2d(in_channels, 1, 3, padding=1))
        self.alpha = alpha
        self.beta = beta

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.alpha * torch.sigmoid(self[0](x.to(torch.float32))) + self.beta


def fused_upsample_conv(conv: Conv2d, h: torch.Tensor, skip: torch.Tensor | None,
                        target_hw: tuple[int, int], stage: int) -> torch.Tensor:
    """``conv`` (3x3, padding 1) of (2x bilinear upsample of ``h`` to
    ``target_hw``, concat ``skip``) before its activation, without the
    upsample (``ops/fused_upconv.py::upconv2x_fused``): the weight's input
    channels are split as the concat lays them out, ``h``'s first. The
    decoder stage ``stage`` must upsample exactly 2x. In the conv's compute
    dtype, as the JAX stage casts (taps composed in that dtype). Under QAT the
    fake-quantized stage; in the int8 twin its int8 stage."""
    if tuple(target_hw) != (2 * h.shape[2], 2 * h.shape[3]):
        raise ValueError(
            "fused_upsample needs an exact 2x stage geometry (input height "
            f"and width divisible by 32); decoder stage {stage} upsamples "
            f"{tuple(h.shape[2:])} to {tuple(target_hw)}")
    if not isinstance(conv, nn.Conv2d):  # the int8 twin's stage (ops/quant.py)
        return conv(h, skip)
    fq = fake_quant_context(conv)
    if fq is not None:
        return fq.fused(conv, h, skip)
    ch = h.shape[1]
    weight, bias = conv.compute_params()
    # on the spatial axis: the stage over this rank's rows and a halo row
    # each side, cropped; the strips and corners of its border corrections
    # land on rows that only the shards at the image's top and bottom keep
    y = spatial.upsample_rows(lambda t: upconv2x_fused(t, weight[:, :ch]),
                              h.to(weight.dtype), 2)
    if skip is None:
        return y + bias[:, None, None]
    return y + spatial.conv2d(skip.to(weight.dtype), weight[:, ch:], bias, padding=1)
