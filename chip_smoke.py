#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``supervised_dispnet_tpu_torch``) on one
CUDA card. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. print the card's name and power limit; build every CUDA kernel from
     ``supervised_dispnet_tpu_torch/csrc`` (one ``nvcc`` per source, all
     started together; timed) and the host image codec
     (``csrc/host/image_codec.cpp``, ``g++``);
  2. kernels, each against its plain PyTorch version on the card:
     - BerHu, forward and backward: one problem at the main-path shape,
       ragged shapes, an all-masked-out case and an all-quadratic case; then
       groups (one launch each way for up to 8 predictions of one target)
       against the per-scale plain loop: the supervised step's 4 scales,
       ragged groups with bool, uint8, float and fractional masks, all masked
       out, all quadratic, misaligned predictions, P = 8, a target above the
       forward's register cache, P = 1 bit for bit against the single entry;
       two runs bit-equal; the groups they refuse; the group's call and
       device time against 4 single calls, and its host time part by part;
     - the bilinear warp sampler's forward, image+coordinate backward and
       coordinate-only backward, at the main-path shape with coordinates from
       a real inverse-warp projection (both padding modes), random
       out-of-bounds coordinates, C=1 and a ragged (3, 37, 53); and the
       cases the image+coordinate backward's shared window has to survive: a
       road scene's smooth-depth projection (both padding modes: in border
       mode the pixels thrown out of view pile onto the edges), near points
       thrown far, an output of another size whose tiles do not divide it,
       C=1 and C=4; the backward's device time (kernel and memset, one each a
       call) on four kinds of coordinates, and ``F.grid_sample``'s;
     - the grouped warp forward and coordinate-only backward (one launch for
       up to 16 problems) on the self-supervised step's 8 problems (both
       padding modes), a ragged group of mixed shapes and a group of 20,
       each problem against the plain sampler and bit for bit against the
       single-problem kernels; the groups they refuse (mixed devices,
       float64, non-contiguous); their device time against 8 single launches
       (profiler), and the single call's host time, part by part;
     - the depth-bin cross-entropy, forward and backward, at the main-path
       shape (4, 128, 416, 64) in the model's NCHW-view layout and
       contiguous, ragged (3, 37, 53) with K=48 and K=100, K=1, all masked
       out, float and fractional masks, logits to ~+-4e4, labels at both
       ends, -inf bins (bin 0 included), P not a multiple of 4, logits
       offset by one float, K=100 and float masks on the 4-pixel path; each
       on the path it must take, with the saved logsumexp against
       ``torch.logsumexp``, each kernel alone against its plain function
       and a second run bit-equal; its device time, one launch a call;
     CUDA-event timings of each kernel, its plain version and, for the
     sampler and the CE, ``F.grid_sample`` and ``F.cross_entropy`` (the
     library yardsticks, never on the path; 8 ``F.grid_sample`` calls for a
     group of 8);
  3. the main paths, each with every launch count set to 0 just before it
     and read just after:
     - supervised BerHu training of DispResNet-50 at 128x416, B=4, through
       ``cli.train.main`` on a packed split written here, with validation
       against GT and ``Trainer.predict`` (1 grouped forward and 1 grouped
       backward BerHu launch of 4 problems a step);
     - self-supervised 3-frame training of DispNetS + PoseExpNet at 128x416,
       B=4, through ``cli.train.main`` on a packed split without depth, so
       validation runs without GT (1 grouped forward and 1 grouped
       coordinate-only warp launch of 8 problems a train step, 1 grouped
       forward launch of 8 a validation batch);
     - depth-as-classification training of DispResNet-50 (64 bins) at
       128x416, B=4, through ``cli.train.main`` as the README runs it, with
       validation against GT (which runs no CE) and ``Trainer.predict`` (1
       forward and 1 backward CE launch a step); then the same with
       ``--multiscale-classification`` for 3 steps (4 + 4 a step);
     - Eigen-split evaluation (BASELINE config 2) through
       ``cli.test_disp.main`` on a synthetic KITTI-raw tree written here (2
       drives of 8 frames at 375x1242, calibration, a 100k-point velodyne
       scan a frame, an Eigen-format list), with the supervised run's
       DispResNet-50 checkpoint at 128x416, batch 8: on the card, on the
       CPU (tables within rel 1e-3), with ``--fused-upsample`` (within rel
       1e-4 of the unfused card run) and with ``--classification`` on the
       classification run's checkpoint; then folder inference (BASELINE
       config 1) through ``cli.run_inference.main`` on the 8 PNGs of one
       drive, card against CPU (depths within rel 1e-3). These paths launch
       none of the port's kernels, and the counts show it. The eval
       forward's time at (8, 128, 416), unfused and fused, with a profile
       (the fused decoder launches no upsample kernel), and the CLI's wall
       time beside the host's decode, GT projection and resize time;
     - odometry pose evaluation through ``cli.test_pose.main`` with the
       self-supervised run's pose checkpoint, on a synthetic sequence of 40
       frames at 375x1242 that it writes, card against CPU (ATE / RE and
       pose vectors within rel 1e-3), with the PoseExpNet forward's time
       at (32, 9, 128, 416); then online serving of the supervised run's
       DispResNet-50 through ``serving.DepthService`` (buckets 1, 8, 64,
       fused and unfused: card against CPU, fused against unfused, 64
       requests from 8 threads, latency at one request in flight and img/s
       at buckets 8 and 64) and through ``cli/serve.py`` in a subprocess
       on a free localhost port (PNG posts and a non-PNG body). These two
       paths launch none of the port's kernels, and the counts show it;
     - VGG-BN and FCRN, supervised BerHu training through ``cli.train.main``
       at 128x416, B=4, 3 steps each (1 grouped forward and 1 grouped
       backward BerHu launch a step, of 4 problems and of 1), their step
       time and profile, their eval forward at (8, 3, 128, 416) card
       against CPU (VGG-BN fused against unfused too) with its time and
       profile, and FCRN's folder inference, card against CPU;
     - the trainer's options: DispResNet-50 BerHu through
       ``cli.train.main`` at 128x416, B=4, with ``--bf16 --ema-decay 0.999
       --accum-steps 2 --hue 0.1 --imagenet-normalization
       --pretrained-encoder`` (a seeded torchvision-layout ResNet-50 written
       here), one epoch of 4 updates, then ``--resume`` for a second (BerHu
       2 + 2 launches an update, float32 inputs at every kernel entry; the
       resumed run continues the first's step, EMA shadow and generator);
       the BerHu, classification, self-supervised and VGG-BN steps in fp32
       and bf16 side by side (img/s from CUDA events, launches a step, busy
       ms, the bf16 kernels in the profile); one bf16 DispResNet-50 step,
       card against CPU (loss rel 1e-2, decoder and heads' gradients rel-L2
       0.1, the encoder's finite with their norm within 2x); remat none /
       full / conv at B=4 and 32 (peak memory, step ms; the same loss,
       gradients and BN statistics); ``--debug-nans`` on a NaN batch and
       ``--profile-steps 2``; what the casts of ``--bf16`` cost
       DispResNet-50's step (a cast a conv, BN in fp32 as well, or one
       multi-tensor cast a forward, beside fp32, in turns);
     - the photometric loss's arms: DispNetS + PoseExpNet at 128x416, B=4,
       through ``cli.train.main`` by default, with ``--half-res-photo`` and
       with ``--stochastic-photo 2``, and with ``batch_refs`` through the
       step builder, 5 steps each (1 grouped forward and 1 grouped
       coordinate-only warp launch a step, of 8 problems; 4 of batch 8 for
       ``batch_refs``): the launches counted and profiled, each arm's
       problems through the grouped kernels against the plain sampler, one
       step card against CPU, step and busy ms; then ``-f 1`` with a
       recording writer (the four training-output images; the warped one a
       single-problem forward launch, held against the CPU port's);
     - the loaders: ``--loader device`` against ``--loader threads`` (the
       same batches bit for bit, the same losses), ``--steps-per-dispatch
       4`` against 4 single steps (parameters, the logged mean, one
       readback), DispResNet-50 BerHu with ``--loader device``;
     - the reference's data path: a synthetic KITTI-raw tree (3 drives x 24
       frames at 375x1242, velodyne, oxts, a static-frames list) and an
       odometry sequence dumped by ``data.prepare_train_data`` in a
       subprocess with cv2, PIL, imageio, joblib and JAX blocked; configs 3
       and 5 trained 5 steps each through ``cli.train.main`` from the JPEG
       dump tree (BerHu grouped 1 + 1 launches a step, warp grouped 1 + 1);
       the dump packed by ``data.packed``'s CLI, the folder and packed
       loaders' first batches bit for bit and config 3's first loss from
       each within rel 1e-6; the host's native and plain PNG decode, JPEG
       decode and encode, the folder loader's frames a second at ``-j 1``
       and ``-j 4`` beside the step's; folder inference over the JPEGs;
     - int8 serving (``int8_phase``): the int8 twins
       (``ops/quant.py::QuantizedModel``) of DispResNet-50 fused and
       unfused, DispNetS, VGG-BN (fused) and FCRN at 128x416, calibrated on
       the card: int8 conv launches a forward equal to the quantized convs,
       the card against the CPU twin, img/s at B=8 and 64 beside fp32 (and
       bf16), peak memory at B=64; every distinct int8 conv of
       DispResNet-50 (chains, fused decoder; the stem's K = 147), FCRN's
       unpool convs and DispNetS's ragged channel counts against the plain
       version (int32 accumulators bit-equal, codes equal, ELU within one)
       and timed beside ``torch._int_mm`` and cuDNN fp32 / bf16;
       ``DepthService(int8=True)`` at buckets 1, 8, 64 beside fp32; the eval
       CLI with ``--int8`` beside fp32; ``cli.train --qat`` 3 steps
       supervised and self-supervised (launches as without it) and a
       fake-quant step card against CPU; an int8 export loaded and run in a
       fresh process;
     - data-parallel training (``parallel_phase``): the given-threshold
       BerHu forward (the second forward launch of a data-parallel step)
       against the plain version with the same c, groups of 1 and 4, two
       runs bit-equal; ``scripts/torch_parallel_run.py`` under
       ``torch.distributed.run`` on 1 rank (NCCL) and on 2 ranks sharing the
       card (gloo): a sum and a max over the ranks, one step of DispResNet-50
       BerHu, DispResNet-50 multi-scale classification and DispNetS +
       PoseExpNet from the same weights on the same global batch of 4, 2
       ranks against 1 (loss, gradients, BN statistics), each rank's
       launches (BerHu 2 forward + 1 backward on 2 ranks, 1 + 1 on one; CE
       1 + 1 a scale; warp 1 + 1), the step times and the collectives'
       share; 3 DispResNet-50 BerHu steps through ``cli.train`` on each,
       their checkpoints side by side;
     - spatial partitioning (``spatial_phase``, ``--spatial-shards``): the
       same script on 2 ranks of one spatial group sharing the card (gloo),
       one step of DispResNet-50 BerHu and multi-scale classification at
       128x416 against the parallel phase's 1-rank run (loss, gradients, BN
       statistics), each rank's launches (BerHu 1 + 1 given-c + 1, CE 4 +
       4), step ms with the all-reduces' and the halo exchanges' ms;
       DispResNet-18 BerHu on 2 data x 2 spatial ranks against 1 rank;
       DispResNet-50 BerHu at 384x1280, a global batch of 2, each shard's
       peak memory against one rank's; 3 BerHu steps through ``cli.train``
       with ``--spatial-shards 2``, its checkpoint's 2-shard eval against a
       1-rank eval of it; the guard (H = 64 at 4 shards raises before any
       collective);
     - ``ops.warp.inverse_warp`` with its default ``diff_img=True`` and a
       backward into the image, depth and pose (the image+coordinate
       backward's path), against the plain sampler on the card;
     the steady-state step time of the three single-scale training paths
     in full fp32 (the math mode the trainer sets), and with TF32 beside
     it, and a profile of the device time by kernel (the classification
     step's: one CE forward and one CE backward kernel);
  4. cross-checks, one train step from identical weights on one batch, TF32
     off: each path (BerHu, classification single- and multi-scale,
     self-supervised) on the card with its kernels against the card with
     the plain versions, and against the CPU with the plain versions; VGG-BN
     and FCRN BerHu steps against the CPU;
  5. ``scripts/torch_convergence_check.py`` for 60 steps of each task
     (supervised disp_res_18, and DispNetS + PoseExpNet on synthetic
     ego-motion scenes): initial and final metrics;
  6. a JSON line of the slice and cross-check numbers, a JSON line of the
     eval and inference numbers, a JSON line of the pose, serving and
     network numbers, a JSON line of the training options' numbers, a JSON
     line of the int8 numbers, a JSON line of the photometric arms',
     loaders', ETL and convergence numbers, a JSON line of the
     data-parallel and spatial numbers, a
     JSON line of kernel numbers, the card line, and as the last line
     ``{"ok": true, "device": {...}}``.

Imports nothing of JAX: the machine with the card has none.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np

REPO = Path(__file__).resolve().parent
MAIN_SHAPE = (4, 128, 416)  # B, H, W of the main path (KITTI width, batch 4)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TPU_KERNEL = "supervised_dispnet_tpu/ops/pallas/losses.py"
TPU_WARP = "supervised_dispnet_tpu/ops/pallas/warp.py"
KITTI_K = ((241.7, 0.0, 208.0), (0.0, 246.3, 64.0), (0.0, 0.0, 1.0))  # at 128x416


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, reps: int = 200, warmup: int = 20) -> float:
    """Mean time of ``fn`` on the card from CUDA events over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _berhu_case(torch, rng, shape, mask_kind="sparse", quadratic=False,
                mask_dtype="bool", device="cuda"):
    gt = rng.uniform(1.0, 80.0, shape).astype(np.float32)
    if quadratic:  # every |d| in [0.5, 1] > c = 0.2 * max|d| <= 0.2
        sign = np.where(rng.uniform(size=shape) < 0.5, -1.0, 1.0)
        pred = gt + (sign * rng.uniform(0.5, 1.0, shape)).astype(np.float32)
    else:
        pred = gt * rng.uniform(0.7, 1.4, shape).astype(np.float32)
    if mask_kind == "none":
        mask = np.zeros(shape, bool)
    elif mask_kind == "all":
        mask = np.ones(shape, bool)
    else:
        mask = rng.uniform(size=shape) < 0.3
    if mask_dtype == "float32":
        mask = mask.astype(np.float32)
    elif mask_dtype == "fractional":  # float weights in (0, 1]
        mask = (mask * rng.uniform(0.05, 1.0, shape)).astype(np.float32)
    dev = torch.device(device)
    return (torch.from_numpy(pred).to(dev), torch.from_numpy(gt).to(dev),
            torch.from_numpy(mask).to(dev))


def _berhu_group(torch, rng, shape, P, misaligned=False, device="cuda", **kwargs):
    """(preds, gt, mask) of a group: P predictions of one target, the
    target and mask of ``_berhu_case``; each prediction gt times its own
    uniform(0.7, 1.4) draw (or, ``quadratic``, gt plus its own |d| in
    [0.5, 1]). ``misaligned``: every prediction starts 4 bytes past a
    16-byte boundary (the kernels' scalar path)."""
    cases = [_berhu_case(torch, rng, shape, device=device, **kwargs) for _ in range(P)]
    _, gt, mask = cases[0]
    preds = [c[0] for c in cases]
    if misaligned:
        n = gt.numel()
        preds = [torch.cat([p.new_zeros(1), p.reshape(-1)])[1:].view(shape) for p in preds]
        assert all(p.data_ptr() % 16 and p.is_contiguous() and p.numel() == n for p in preds)
    return preds, gt, mask


STEP_WEIGHTS = (1.0, 0.5, 0.25, 0.125)  # multiscale_supervised_loss's


def _plain_group(torch, preds, gt, mask, weights):
    """The per-scale loop with the plain BerHu on the same device: the
    weighted total, each problem's loss, and the total's gradients w.r.t.
    the predictions and gt (upstream gradient 1)."""
    from supervised_dispnet_tpu_torch.losses.supervised import berhu_loss_plain

    ps = [p.detach().clone().requires_grad_(True) for p in preds]
    g = gt.detach().clone().requires_grad_(True)
    total = torch.zeros((), dtype=torch.float32, device=gt.device)
    losses = []
    for p, w in zip(ps, weights):
        loss = berhu_loss_plain(p, g, mask)
        losses.append(loss.detach())
        total = total + w * loss
    grads = torch.autograd.grad(total, ps + [g])
    return total.detach(), losses, grads[:-1], grads[-1]


def _berhu_group_agrees(torch, kl, name: str, preds, gt, mask, weights) -> tuple[float, float]:
    """One group through ``berhu_loss_many_cuda`` (forward and backward,
    gt taking a gradient) against the per-scale plain loop on the card:
    total and each loss rtol 1e-5, each gradient (the predictions' and
    gt's) rtol 1e-5 / atol 1e-7, the count exact (rel 1e-6 for a float
    mask: its sum is taken in another order), c rel 1e-6; one launch each
    way for the group; the forward and the backward run again give the same
    bits. Returns the largest errors (loss, gradient)."""
    P = len(preds)
    counters = ("berhu_fwd_launches", "berhu_bwd_launches", "berhu_fwd_problems")
    before = [getattr(kl, c) for c in counters]
    ps = [p.detach().clone().requires_grad_(True) for p in preds]
    g = gt.detach().clone().requires_grad_(True)
    total = kl.berhu_loss_many_cuda(ps, g, mask, weights)
    grads = torch.autograd.grad(total, ps + [g])
    counted = [getattr(kl, c) - b for c, b in zip(counters, before)]
    stats = kl.berhu_forward_many(preds, gt, mask, weights)
    again = kl.berhu_forward_many(preds, gt, mask, weights)
    one = torch.ones((), device=gt.device)
    dp = kl.berhu_backward_many(preds, gt, mask, stats, weights, one)
    dp_again = kl.berhu_backward_many(preds, gt, mask, again, weights, one)
    total_p, losses_p, dps_p, dgt_p = _plain_group(torch, preds, gt, mask, weights)
    torch.cuda.synchronize()
    count = mask.to(torch.float32).sum()
    rel_count = 1e-6 if mask.dtype == torch.float32 else 0.0
    st = stats[:3 * P].view(P, 3)
    m = mask.to(torch.float32)
    c_plain = [float((0.2 * ((p - gt) * m).abs().max()).clamp(min=1e-6)) for p in preds]
    checks = {
        "launches": counted == [1, 1, P],
        "total": torch.allclose(total, total_p, rtol=1e-5, atol=0.0),
        "losses": all(torch.allclose(st[k, 0], losses_p[k], rtol=1e-5, atol=0.0)
                      for k in range(P)),
        "stats total": torch.allclose(stats[3 * P], total_p, rtol=1e-5, atol=0.0),
        "count": all(math.isclose(float(st[k, 1]), float(count), rel_tol=rel_count)
                     for k in range(P)),
        "dpreds": all(torch.allclose(a, b, rtol=1e-5, atol=1e-7)
                      for a, b in zip(grads[:-1], dps_p)),
        "dgt": torch.allclose(grads[-1], dgt_p, rtol=1e-5, atol=1e-7),
        "== direct backward": all(torch.equal(a, b) for a, b in zip(grads[:-1], dp)),
        "two runs bit-equal": (torch.equal(stats, again)
                               and all(torch.equal(a, b) for a, b in zip(dp, dp_again))),
        "c": all(math.isclose(float(st[k, 2]), c, rel_tol=1e-6)
                 for k, c in enumerate(c_plain)),
        "finite": bool(torch.isfinite(stats).all()
                       and all(torch.isfinite(d).all() for d in grads)),
    }
    total = total.detach()
    e_l = max(abs(float(total) - float(total_p)),
              max(abs(float(st[k, 0]) - float(losses_p[k])) for k in range(P)))
    e_g = max(float((a - b).abs().max()) for a, b in zip(grads, list(dps_p) + [dgt_p]))
    bad = [k for k, ok in checks.items() if not ok]
    print(f"  berhu group {name}: P={P}, launches {counted[0]} + {counted[1]} ({counted[2]} "
          f"problems); total kernel {float(total):.7g} plain {float(total_p):.7g}; max abs "
          f"err loss {e_l:.3g}, grad {e_g:.3g}; count {float(st[0, 1]):.7g}, c "
          f"{[round(float(c), 6) for c in st[:, 2]]}; two runs bit-equal "
          f"{checks['two runs bit-equal']}", flush=True)
    if bad:
        raise AssertionError(f"grouped berhu kernels disagree on {name}: {bad}")
    return e_l, e_g


def berhu_call_breakdown(torch, preds, gt, mask) -> dict:
    """Where the host's time of a call goes (host clock; each part of the
    wrapper timed alone), over the step's group of 4: the checks, the one
    allocation, the packed table, the stream lookup, the ``ctypes`` call
    (which launches the kernel), the forward's whole wrapper, the backward's,
    the autograd forward (one node) and forward + backward; the 4
    single-problem calls (the parent's shape of the step) beside them; and
    ``torch.autograd.grad`` of a one-element product, the autograd engine's
    own cost on this host."""
    from supervised_dispnet_tpu_torch.ops.cuda import losses as kl

    w = STEP_WEIGHTS
    P, n = len(preds), gt.numel()
    m8, mask_is_float, index = kl._check_group(preds, gt, mask, w)
    size = 3 * P + 1 + (2 * P + 1) * kl.SCRATCH_BLOCKS
    buf = torch.empty(size, dtype=torch.float32, device=gt.device)
    lib, stream, table = kl._lib(), kl._stream(index), kl._table(preds, (), w)
    ptrs = (gt.data_ptr(), m8.data_ptr(), int(mask_is_float), n, 0.2, buf.data_ptr(),
            buf.data_ptr() + 4 * (3 * P + 1), kl.SCRATCH_BLOCKS, index, stream)
    stats = kl.berhu_forward_many(preds, gt, mask, w)
    g = torch.ones((), device=gt.device)
    req = [p.detach().clone().requires_grad_(True) for p in preds]
    x = torch.ones(1, device=gt.device, requires_grad=True)

    def autograd_step():
        torch.autograd.grad(kl.berhu_loss_many_cuda(req, gt, mask, w), req)

    def single_step():
        total = torch.zeros((), device=gt.device)
        for p, wk in zip(req, w):
            total = total + wk * kl.berhu_loss_cuda(p, gt, mask)
        torch.autograd.grad(total, req)

    parts = {
        "checks": lambda: kl._check_group(preds, gt, mask, w),
        "alloc": lambda: torch.empty(size, dtype=torch.float32, device=gt.device),
        "table": lambda: kl._table(preds, (), w),
        "stream": lambda: kl._stream(index),
        "ctypes": lambda: lib.berhu_forward_many(table, P, *ptrs),
        "fwd_wrapper": lambda: kl.berhu_forward_many(preds, gt, mask, w),
        "bwd_wrapper": lambda: kl.berhu_backward_many(preds, gt, mask, stats, w, g),
        "autograd_fwd": lambda: kl.berhu_loss_many_cuda(req, gt, mask, w),
        "autograd_fwd_bwd": autograd_step,
        "single_x4_fwd_wrapper": lambda: [kl.berhu_forward_stats(p, gt, mask) for p in preds],
        "single_x4_autograd_fwd_bwd": single_step,
        "trivial_autograd_fwd_bwd": lambda: torch.autograd.grad((x * 2).sum(), x),
    }
    us = {k: host_us(torch, f) for k, f in parts.items()}
    print("  berhu group of 4, host us a call: "
          + ", ".join(f"{k} {v:.2f}" for k, v in us.items()), flush=True)
    return us


def kernel_phase(torch, device: str = "cuda") -> dict:
    """The BerHu kernels against the plain version on the card.
    Tolerances: loss rtol 1e-5, gradient rtol 1e-5 / atol 1e-7; they differ
    only in summation order.

    - One problem (the single-problem entries: the grouped kernels with P =
      1 and weight 1) on seven cases: the main path's shape, ragged shapes
      with bool, float and fractional masks, all masked out (stats [0, 0,
      1e-6]), every |d| > c.
    - Groups (``berhu_loss_many_cuda``) against the per-scale plain loop
      (``_berhu_group_agrees``): the supervised step's group (P = 4 at the
      main shape, weights (1, .5, .25, .125)); ragged (3, 37, 53) groups with
      bool, float and fractional masks; all masked out; every |d| > c;
      misaligned predictions (the scalar path); P = 8; a target too large
      for the forward's register cache; P = 1 bit for bit against the
      single entry; and what the grouped entries refuse on the card, with no
      launch counted.
    - Over the step's group: CUDA-event times of the grouped calls, of 4
      single calls and of the plain loop; the device time of the grouped
      launches and of 4 single ones (profiler); the bounds; the host time
      part by part."""
    from supervised_dispnet_tpu_torch.losses.supervised import berhu_loss_plain
    from supervised_dispnet_tpu_torch.ops.cuda import losses as kl

    rng = np.random.default_rng(0)
    ragged = (3, 37, 53)

    def case(shape, **kwargs):
        return _berhu_case(torch, rng, shape, device=device, **kwargs)

    def group(shape, P, **kwargs):
        return _berhu_group(torch, rng, shape, P, device=device, **kwargs)

    cases = {
        "main (4,128,416)": case(MAIN_SHAPE),
        "ragged (3,37,53)": case(ragged),
        "ragged (3,37,53) float mask": case(ragged, mask_dtype="float32"),
        "ragged (3,37,53) fractional mask": case(ragged, mask_dtype="fractional"),
        "ragged (1,1,7)": case((1, 1, 7), mask_kind="all"),
        "all masked out (4,128,416)": case(MAIN_SHAPE, mask_kind="none"),
        "every |d| > c (3,37,53)": case(ragged, mask_kind="all", quadratic=True),
    }
    err_fwd = err_bwd = 0.0
    for name, (pred, gt, mask) in cases.items():
        p_k = pred.clone().requires_grad_(True)
        p_p = pred.clone().requires_grad_(True)
        loss_k = kl.berhu_loss_cuda(p_k, gt, mask)
        loss_k.backward()
        loss_p = berhu_loss_plain(p_p, gt, mask)
        loss_p.backward()
        stats = kl.berhu_forward_stats(pred, gt, mask)
        torch.cuda.synchronize()
        count = mask.to(torch.float32).sum()
        ok_loss = torch.allclose(loss_k, loss_p, rtol=1e-5, atol=0.0)
        ok_grad = torch.allclose(p_k.grad, p_p.grad, rtol=1e-5, atol=1e-7)
        ok_count = math.isclose(float(stats[1]), float(count), rel_tol=1e-6)
        lk, lp = float(loss_k.detach()), float(loss_p.detach())
        e_f = abs(lk - lp)
        e_b = float((p_k.grad - p_p.grad).abs().max())
        err_fwd, err_bwd = max(err_fwd, e_f), max(err_bwd, e_b)
        print(f"  berhu {name}: loss kernel {lk:.7g} plain {lp:.7g} "
              f"(abs err {e_f:.3g}); grad max abs err "
              f"{e_b:.3g}; count {float(stats[1]):.0f}, c {float(stats[2]):.6g}",
              flush=True)
        if not (ok_loss and ok_grad and ok_count):
            raise AssertionError(f"berhu kernel disagrees with the plain version "
                                 f"on {name}: loss {ok_loss}, grad {ok_grad}, "
                                 f"count {ok_count}")
    stats0 = kl.berhu_forward_stats(*cases["all masked out (4,128,416)"]).tolist()
    if stats0 != [0.0, 0.0, float(np.float32(1e-6))]:
        raise AssertionError(f"all-masked-out stats {stats0} != [0, 0, 1e-6]")

    # groups against the per-scale plain loop
    w4 = STEP_WEIGHTS
    step = group(MAIN_SHAPE, 4)
    tiny = group((1, 1, 7), 2, mask_kind="all")
    groups = {
        f"step group {MAIN_SHAPE}": (step, w4),
        "ragged (3,37,53) bool mask": (group(ragged, 4), w4),
        "ragged (3,37,53) float mask": (group(ragged, 4, mask_dtype="float32"), w4),
        "ragged (3,37,53) fractional mask": (group(ragged, 3, mask_dtype="fractional"),
                                             (0.7, 1.3, 0.2)),
        f"all masked out {MAIN_SHAPE}": (group(MAIN_SHAPE, 4, mask_kind="none"), w4),
        "every |d| > c (3,37,53)": (group(ragged, 4, mask_kind="all", quadratic=True), w4),
        "misaligned predictions (3,37,53)": (group(ragged, 4, misaligned=True), w4),
        "ragged (1,1,7) uint8 mask": ((*tiny[:2], tiny[2].to(torch.uint8)), (1.0, 0.5)),
        f"P=8 {MAIN_SHAPE}": (group(MAIN_SHAPE, 8), tuple(0.5 ** k for k in range(8))),
        "above the register cache (8,256,832) P=2": (group((8, 256, 832), 2), (1.0, 0.5)),
        "P=1 (4,128,416)": ((step[0][:1], *step[1:]), (1.0,)),
    }
    err_gf = err_gb = 0.0
    for name, ((preds, gt, mask), weights) in groups.items():
        e_l, e_g = _berhu_group_agrees(torch, kl, name, preds, gt, mask, weights)
        err_gf, err_gb = max(err_gf, e_l), max(err_gb, e_g)
    preds, gt, mask = groups[f"all masked out {MAIN_SHAPE}"][0]
    zero = kl.berhu_forward_many(preds, gt, mask, w4).tolist()
    if zero != [0.0, 0.0, float(np.float32(1e-6))] * 4 + [0.0]:
        raise AssertionError(f"all-masked-out group stats {zero} != [0, 0, 1e-6] x 4, 0")
    pred, gt, mask = step[0][0], step[1], step[2]
    one = torch.ones((), device=gt.device)
    s1, s_many = kl.berhu_forward_stats(pred, gt, mask), kl.berhu_forward_many([pred], gt, mask,
                                                                             (1.0,))
    if not (torch.equal(s1, s_many[:3]) and torch.equal(s_many[3], s1[0]) and torch.equal(
            kl.berhu_backward(pred, gt, mask, s1, one),
            kl.berhu_backward_many([pred], gt, mask, s_many, (1.0,), one)[0])):
        raise AssertionError("the P=1 group is not bit-equal to the single-problem entry")
    print("  berhu P=1 group: bit-equal to the single-problem entries (stats, total = loss, "
          "gradient)", flush=True)

    # what the grouped entries refuse on the card, before any launch
    preds, gt, mask = step
    stats1 = kl.berhu_forward_many(preds[:1], gt, mask, (1.0,))
    refusals = {
        "a CPU prediction": (ValueError, lambda: kl.berhu_forward_many(
            [preds[0], preds[1].cpu()], gt, mask, (1.0, 0.5))),
        "a float64 prediction": (TypeError, lambda: kl.berhu_forward_many(
            [preds[0].double()], gt, mask, (1.0,))),
        "a non-contiguous prediction": (ValueError, lambda: kl.berhu_forward_many(
            [preds[0].transpose(1, 2).contiguous().transpose(1, 2)], gt, mask, (1.0,))),
        "a shape mismatch": (ValueError, lambda: kl.berhu_forward_many(
            [preds[0][:, 1:]], gt, mask, (1.0,))),
        "9 predictions": (ValueError, lambda: kl.berhu_forward_many(
            preds * 2 + preds[:1], gt, mask, (1.0,) * 9)),
        "fewer weights than predictions": (ValueError, lambda: kl.berhu_backward_many(
            preds, gt, mask, stats1, (1.0,), one)),
        "an int32 mask": (TypeError, lambda: kl.berhu_forward_many(
            preds, gt, mask.to(torch.int32), w4)),
    }
    counters = ("berhu_fwd_launches", "berhu_bwd_launches", "berhu_fwd_problems")
    before = [getattr(kl, c) for c in counters]
    for name, (exc, call) in refusals.items():
        try:
            call()
        except exc:
            continue
        raise AssertionError(f"the grouped berhu entries took {name}")
    if [getattr(kl, c) for c in counters] != before:
        raise AssertionError("a refused group moved a berhu counter")
    print(f"  berhu group refusals: {', '.join(refusals)}; no launch counted", flush=True)

    # timings: one problem at the main path's shape, then the step's group
    pred, gt, mask = cases["main (4,128,416)"]
    n = pred.numel()
    p_req = pred.clone().requires_grad_(True)
    plain_loss = berhu_loss_plain(p_req, gt, mask)
    stats = kl.berhu_forward_stats(pred, gt, mask)
    preds, sgt, smask = step
    sstats = kl.berhu_forward_many(preds, sgt, smask, w4)
    singles = [kl.berhu_forward_stats(p, sgt, smask) for p in preds]

    def plain_total(ps):
        total = torch.zeros((), device=sgt.device)
        for p, wk in zip(ps, w4):
            total = total + wk * berhu_loss_plain(p, sgt, smask)
        return total

    reqs = [p.clone().requires_grad_(True) for p in preds]
    total_p = plain_total(reqs)
    t = {
        "fwd": cuda_ms(torch, lambda: kl.berhu_forward_stats(pred, gt, mask)),
        "fwd_plain": cuda_ms(torch, lambda: berhu_loss_plain(pred, gt, mask)),
        "bwd": cuda_ms(torch, lambda: kl.berhu_backward(pred, gt, mask, stats, one)),
        "bwd_plain": cuda_ms(torch, lambda: torch.autograd.grad(
            plain_loss, p_req, retain_graph=True)),
        "fwd_group": cuda_ms(torch, lambda: kl.berhu_forward_many(preds, sgt, smask, w4)),
        "fwd_group_single_x4": cuda_ms(torch, lambda: [kl.berhu_forward_stats(p, sgt, smask)
                                                       for p in preds]),
        "fwd_group_plain": cuda_ms(torch, lambda: plain_total(preds)),
        "bwd_group": cuda_ms(torch, lambda: kl.berhu_backward_many(
            preds, sgt, smask, sstats, w4, one)),
        "bwd_group_single_x4": cuda_ms(torch, lambda: [kl.berhu_backward(p, sgt, smask, s, one)
                                                       for p, s in zip(preds, singles)]),
        "bwd_group_plain": cuda_ms(torch, lambda: torch.autograd.grad(
            total_p, reqs, retain_graph=True)),
    }
    # the least each must move (preds, gt f32 and the 1-byte mask read once,
    # the stats or the gradients written once) and do (~10 flops an element
    # and problem forward, ~6 backward)
    P = len(preds)
    bounds = {
        "berhu_fwd": bound_ms(9 * n + 12, 10 * n),
        "berhu_bwd": bound_ms(9 * n + 12 + 4 + 4 * n, 6 * n),
        "berhu_fwd_group": bound_ms((4 * P + 5) * n + 4 * (3 * P + 1), 10 * P * n),
        "berhu_bwd_group": bound_ms((4 * P + 5) * n + 4 * (3 * P + 1) + 4 + 4 * P * n,
                                    6 * P * n),
    }
    fwd_k, bwd_k = "berhu_forward_group_kernel", "berhu_backward_group_kernel"
    d_group = device_us(torch, lambda: (kl.berhu_forward_many(preds, sgt, smask, w4),
                                        kl.berhu_backward_many(preds, sgt, smask, sstats, w4,
                                                               one)), (fwd_k, bwd_k))
    d_single = device_us(torch, lambda: [(kl.berhu_forward_stats(p, sgt, smask),
                                          kl.berhu_backward(p, sgt, smask, s, one))
                                         for p, s in zip(preds, singles)], (fwd_k, bwd_k))
    dev = {"fwd_group": d_group[fwd_k][0], "bwd_group": d_group[bwd_k][0],
           "fwd": d_single[fwd_k][0], "bwd": d_single[bwd_k][0]}
    print(f"  berhu main path, one problem: fwd kernel_ms {t['fwd']:.5f} plain_ms "
          f"{t['fwd_plain']:.5f} device_us {dev['fwd']:.2f} bound_us "
          f"{bounds['berhu_fwd'][0] * 1e3:.3f}; bwd kernel_ms {t['bwd']:.5f} plain_ms "
          f"{t['bwd_plain']:.5f} device_us {dev['bwd']:.2f} bound_us "
          f"{bounds['berhu_bwd'][0] * 1e3:.3f}; library_ms null", flush=True)
    for key in ("fwd", "bwd"):
        row, k = f"berhu_{key}_group", f"{key}_group"
        bound_us = bounds[row][0] * 1e3
        print(f"  berhu step group (4 problems): {key} grouped_ms {t[k]:.5f} single_x4_ms "
              f"{t[k + '_single_x4']:.5f} plain_loop_ms {t[k + '_plain']:.5f}; device "
              f"{dev[k]:.2f} us a launch, {d_group[fwd_k if key == 'fwd' else bwd_k][1]:g} a "
              f"call; 4 single launches {4 * dev[key]:.2f} us; bound {bound_us:.3f} us, "
              f"{bound_us / dev[k]:.1%} of it", flush=True)
    breakdown = berhu_call_breakdown(torch, preds, sgt, smask)

    src = "supervised_dispnet_tpu_torch/csrc/berhu.cu"
    out = {}
    for name, key, line, err in (("berhu_fwd", "fwd", 203, err_fwd),
                                 ("berhu_bwd", "bwd", 238, err_bwd),
                                 ("berhu_fwd_group", "fwd_group", 203, err_gf),
                                 ("berhu_bwd_group", "bwd_group", 238, err_gb)):
        out[name] = {"name": name, "route": "cuda", "source": src,
                     "replaces": f"{TPU_KERNEL}:{line}", "max_abs_err": err,
                     "ms": t[key], "plain_ms": t[f"{key}_plain"],
                     "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                     "library_ms": None, "device_us": dev[key]}
        if key.endswith("group"):
            out[name].update(problems=P, single_x4_ms=t[f"{key}_single_x4"],
                             single_device_us_x4=4 * dev[key.split("_")[0]],
                             **({"host_us": breakdown} if key == "fwd_group" else {}))
    return out


def _ce_case(torch, rng, shape, K, layout="nchw", mask_kind="sparse", spread=1.0,
             depth="uniform", device="cuda"):
    """(logits, labels, mask) on the card. Logits unit-normal times
    ``spread``, in the model's layout (the (B, H, W, K) view of an NCHW
    tensor) or contiguous; labels ``DepthBins(K).depth_to_index`` of GT
    depth over [0.5, 90] m (``depth='ends'``: only depths beyond both ends,
    labels 0 and K-1); the mask ~10% sparse bool, all False, float 0/1, or
    fractional float weights."""
    from supervised_dispnet_tpu_torch.losses.classification import DepthBins

    dev = torch.device(device)
    if layout == "nchw":
        B, H, W = shape
        nchw = rng.standard_normal((B, K, H, W)).astype(np.float32) * spread
        logits = torch.from_numpy(nchw).to(dev).permute(0, 2, 3, 1)
    else:
        logits = torch.from_numpy(
            rng.standard_normal((*shape, K)).astype(np.float32) * spread).to(dev)
    if depth == "ends":
        gt = np.where(rng.uniform(size=shape) < 0.5, 0.5, 95.0)
    else:
        gt = rng.uniform(0.5, 90.0, shape)
    labels = DepthBins(num_bins=K).depth_to_index(
        torch.from_numpy(gt.astype(np.float32)).to(dev))
    sparse = rng.uniform(size=shape) < 0.1
    mask = {"sparse": sparse, "none": np.zeros(shape, bool),
            "float": sparse.astype(np.float32),
            "fractional": (sparse * rng.uniform(0.05, 1.0, shape)).astype(np.float32),
            }[mask_kind]
    return logits, labels, torch.from_numpy(mask).to(dev)


def ce_bounds(N: int, K: int) -> dict:
    """(bound ms, what bounds it) of the CE forward and backward over N
    pixels of K bins: the least each must move (logits f32, labels i32, a
    one-byte mask read once; the forward writes [loss, count] and the lse,
    2 floats a pixel, which the backward reads with [loss, count] and g,
    writing dlogits once) and do (~5 flops a logit forward: max, subtract,
    exp, add; ~8 backward)."""
    in_bytes = 4 * N * K + 4 * N + N
    return {"ce_fwd": bound_ms(in_bytes + 8 * N + 8, 5 * N * K),
            "ce_bwd": bound_ms(in_bytes + 8 * N + 8 + 4 + 4 * N * K, 8 * N * K)}


def _minus_inf_bins(torch, rng, logits, labels) -> None:
    """Set bins of ``logits`` to -inf in place: bin 0 in ~20% of the pixels,
    the 20 leading bins in ~20%, every third bin in ~20%; never a pixel's
    label bin, so the loss stays finite."""
    shape, K = logits.shape[:-1], logits.shape[-1]
    u = torch.from_numpy(rng.uniform(size=shape)).to(logits.device)[..., None]
    k = torch.arange(K, device=logits.device)
    kill = (((u < 0.2) & (k == 0)) | ((u >= 0.2) & (u < 0.4) & (k < 20))
            | ((u >= 0.4) & (u < 0.6) & (k % 3 == 0)))
    logits.masked_fill_(kill & (k != labels[..., None].long()), -math.inf)


def ce_phase(torch, device: str = "cuda") -> dict:
    """The CE kernels against ``depth_classification_loss_plain`` on the
    card, loss and logits-gradient (upstream gradient 0.7), on both paths
    (4 pixels a thread with 16-byte accesses, or one; each case states which
    ``vector_path`` must pick). Tolerances: loss rtol 1e-5; gradient rtol
    1e-5 with atol 1e-6 of its largest entry (an entry is ~1/count, so a
    fixed atol would test nothing); they differ only in summation order and
    in exp((x - lse) - lse_lo) against exp(log-softmax). Also per case: the
    saved lse against ``torch.logsumexp`` (rtol 1e-6); each kernel alone
    against its plain function (``ce_forward_plain``: loss rtol 1e-5, count
    and lse rtol 1e-6; ``ce_backward_plain`` from the kernel's own lse: the
    gradient's tolerance); a second run bit-equal, loss and gradient. K=1
    and all masked out give exactly 0. Then timings and device time at the
    main path's shape, each call one kernel launch and nothing else."""
    from supervised_dispnet_tpu_torch.losses.classification import (
        depth_classification_loss_plain)
    from supervised_dispnet_tpu_torch.ops.cuda import classification as kc

    rng = np.random.default_rng(7)
    B, H, W = MAIN_SHAPE
    main = f"main ({B},{H},{W},64)"

    def case(*args, **kwargs):
        return _ce_case(torch, rng, *args, device=device, **kwargs)

    # name: (logits, labels, mask); `vector` below names the cases the 4-pixel path takes
    cases = {
        f"{main} NCHW view": case(MAIN_SHAPE, 64),
        f"{main} contiguous": case(MAIN_SHAPE, 64, layout="contiguous"),
        "ragged (3,37,53,48) NCHW view": case((3, 37, 53), 48),
        "ragged (3,37,53,100) contiguous": case((3, 37, 53), 100, layout="contiguous"),
        "K=1 (3,37,53,1)": case((3, 37, 53), 1),
        f"all masked out {main}": case(MAIN_SHAPE, 64, mask_kind="none"),
        "float mask (3,37,53,64)": case((3, 37, 53), 64, mask_kind="float"),
        "fractional mask (3,37,53,64)": case((3, 37, 53), 64, mask_kind="fractional"),
        "logits N(0, 1e4), to ~+-4e4 (3,37,53,64)": case((3, 37, 53), 64, spread=1e4),
        "labels 0 and K-1 only (3,37,53,64)": case((3, 37, 53), 64, depth="ends"),
        "-inf bins, bin 0 included (2,36,52,64) NCHW view": case((2, 36, 52), 64),
        "-inf bins, bin 0 included (3,37,53,64) NCHW view": case((3, 37, 53), 64),
        "P not a multiple of 4 (2,37,53,64) NCHW view": case((2, 37, 53), 64),
        "K=100 (2,36,52,100) NCHW view": case((2, 36, 52), 100),
        "float mask (2,36,52,64) NCHW view": case((2, 36, 52), 64, mask_kind="float"),
        "fractional mask (2,36,52,64) NCHW view": case((2, 36, 52), 64,
                                                       mask_kind="fractional"),
    }
    for name, (logits, labels, _) in cases.items():
        if name.startswith("-inf"):
            _minus_inf_bins(torch, rng, logits, labels)
    x, labels, mask = cases[f"{main} NCHW view"]
    shifted = torch.empty(x.numel() + 1, device=device)[1:].view(B, 64, H, W)
    shifted.copy_(x.permute(0, 3, 1, 2))
    cases[f"logits offset by one float {main} NCHW view"] = (
        shifted.permute(0, 2, 3, 1), labels, mask)
    # the NCHW view with P a multiple of 4 at aligned addresses
    vector = {f"{main} NCHW view", f"all masked out {main}",
              *(name for name in cases if "(2,36,52" in name)}

    g = torch.tensor(0.7, device=device)
    err_fwd = err_bwd = 0.0
    for name, (logits, labels, mask) in cases.items():
        l_k = logits.detach().requires_grad_(True)
        l_p = logits.detach().requires_grad_(True)
        loss_k = kc.cross_entropy_cuda(l_k, labels, mask)
        (d_k,) = torch.autograd.grad(loss_k, l_k, g)
        l_r = logits.detach().requires_grad_(True)
        loss_r = kc.cross_entropy_cuda(l_r, labels, mask)
        (d_r,) = torch.autograd.grad(loss_r, l_r, g)
        loss_p = depth_classification_loss_plain(l_p, None, mask, labels=labels)
        (d_p,) = torch.autograd.grad(loss_p, l_p, g)
        stats, lse = kc.ce_forward(logits, labels, mask)
        stats_p, lse_p = kc.ce_forward_plain(logits, labels, mask)
        d_s = kc.ce_backward(logits, labels, mask, lse, stats, g)
        d_sp = kc.ce_backward_plain(logits, labels, mask, lse, stats, g)
        torch.cuda.synchronize()
        scale = float(d_p.abs().max())
        lk, lp = float(loss_k.detach()), float(loss_p.detach())
        e_f, e_b = abs(lk - lp), float((d_k - d_p).abs().max())
        e_lse = float((lse[0] - torch.logsumexp(logits, -1)).abs().max())
        err_fwd, err_bwd = max(err_fwd, e_f), max(err_bwd, e_b)
        path = kc.vector_path(logits, labels, mask)

        def close(a, b, rtol):
            return torch.allclose(a, b, rtol=rtol, atol=0.0)

        checks = {
            "loss": close(loss_k, loss_p, 1e-5),
            "grad": torch.allclose(d_k, d_p, rtol=1e-5, atol=1e-6 * scale),
            "grad layout": d_k.stride() == logits.stride(),
            "count": math.isclose(float(stats[1]), float(mask.float().sum()), rel_tol=1e-6),
            "finite": bool(torch.isfinite(loss_k) and torch.isfinite(d_k).all()),
            "path": path == (name in vector),
            "lse": close(lse[0], torch.logsumexp(logits, -1), 1e-6),
            "forward kernel vs ce_forward_plain": (
                close(stats[0], stats_p[0], 1e-5) and close(stats[1], stats_p[1], 1e-6)
                and close(lse.double().sum(0), lse_p.double().sum(0), 1e-6)),
            "backward kernel vs ce_backward_plain": torch.allclose(
                d_s, d_sp, rtol=1e-5, atol=1e-6 * scale),
            "two runs bit-equal": bool(torch.equal(loss_k, loss_r) and torch.equal(d_k, d_r)),
        }
        lab = (int(labels.min()), int(labels.max()))
        print(f"  ce {name} [{'vector' if path else 'scalar'} path]: loss kernel {lk:.7g} "
              f"plain {lp:.7g} (abs err {e_f:.3g}); grad max abs err {e_b:.3g} of max|g| "
              f"{scale:.3g}; lse max abs err {e_lse:.3g}; count {float(stats[1]):.6g}; "
              f"labels in [{lab[0]}, {lab[1]}]", flush=True)
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"ce kernels disagree with the plain version on {name}: {bad}")
    for name in ("K=1 (3,37,53,1)", f"all masked out {main}"):
        logits, labels, mask = cases[name]
        l_k = logits.detach().requires_grad_(True)
        loss_k = kc.cross_entropy_cuda(l_k, labels, mask)
        loss_k.backward()
        if loss_k.item() != 0.0 or bool(l_k.grad.any()):
            raise AssertionError(f"ce {name}: loss {loss_k.item()} and gradient not 0")

    # timings at the main path's shape, in the model's layout
    F = torch.nn.functional
    logits, labels, mask = cases[f"{main} NCHW view"]
    N, K = labels.numel(), logits.shape[-1]
    l_req = logits.detach().requires_grad_(True)
    plain_loss = depth_classification_loss_plain(l_req, None, mask, labels=labels)
    stats, lse = kc.ce_forward(logits, labels, mask)
    # the library: F.cross_entropy over the NCHW tensor with the masked-out
    # pixels' labels set to ignore_index computes the same function
    nchw = logits.permute(0, 3, 1, 2)
    target = labels.masked_fill(~mask, -100).long()
    lib_in = nchw.detach().requires_grad_(True)
    lib_loss = F.cross_entropy(lib_in, target, ignore_index=-100)
    if not torch.allclose(lib_loss, plain_loss, rtol=1e-5, atol=0.0):
        raise AssertionError("F.cross_entropy(ignore_index) is not the same function")

    def fwd():
        return kc.ce_forward(logits, labels, mask)

    def bwd():
        return kc.ce_backward(logits, labels, mask, lse, stats, g)

    t = {
        "fwd": cuda_ms(torch, fwd),
        "fwd_plain": cuda_ms(torch, lambda: depth_classification_loss_plain(
            logits, None, mask, labels=labels)),
        "fwd_lib": cuda_ms(torch, lambda: F.cross_entropy(nchw, target, ignore_index=-100)),
        "bwd": cuda_ms(torch, bwd),
        "bwd_plain": cuda_ms(torch, lambda: torch.autograd.grad(
            plain_loss, l_req, retain_graph=True)),
        "bwd_lib": cuda_ms(torch, lambda: torch.autograd.grad(
            lib_loss, lib_in, retain_graph=True)),
    }
    # device time a launch, from a profile with one event of the kernel a
    # call and no other device event (a memset or another kernel would show
    # as more events, a second launch as ~2 a call); the profiler can drop
    # events, so a profile that shows fewer is taken again
    dev = {key: launch_device_us(torch, fn, [kernel])[kernel]
           for key, fn, kernel in (("fwd", fwd, "ce_forward_kernel"),
                                   ("bwd", bwd, "ce_backward_kernel"))}
    bounds = ce_bounds(N, K)
    print(f"  ce {main}: fwd kernel_ms {t['fwd']:.5f} device_us {dev['fwd']:.2f} plain_ms "
          f"{t['fwd_plain']:.5f} cross_entropy_ms {t['fwd_lib']:.5f}; bwd kernel_ms "
          f"{t['bwd']:.5f} device_us {dev['bwd']:.2f} plain_ms {t['bwd_plain']:.5f} "
          f"cross_entropy_ms {t['bwd_lib']:.5f}; bound_us "
          + ", ".join(f"{k} {v[0] * 1e3:.3f}" for k, v in bounds.items())
          + "; share of the bound "
          + ", ".join(f"{k} {bounds[f'ce_{k}'][0] * 1e3 / dev[k]:.1%}" for k in dev),
          flush=True)
    src = "supervised_dispnet_tpu_torch/csrc/ce.cu"
    return {
        name: {"name": name, "route": "cuda", "source": src,
               "replaces": f"{TPU_KERNEL}:{line}", "max_abs_err": err,
               "ms": t[key], "plain_ms": t[f"{key}_plain"], "bound_ms": bounds[name][0],
               "bound_by": bounds[name][1], "library_ms": t[f"{key}_lib"],
               "device_us": dev[key]}
        for name, key, line, err in (("ce_fwd", "fwd", 52, err_fwd),
                                     ("ce_bwd", "bwd", 80, err_bwd))
    }


def _kitti_k(torch, B: int, H: int, W: int):
    """KITTI's intrinsics scaled to (H, W), (B, 3, 3)."""
    return torch.tensor(KITTI_K).expand(B, 3, 3) * torch.tensor(
        [[W / 416, 1, W / 416], [1, H / 128, H / 128], [1, 1, 1]])


def _projection_coords(torch, B: int, H: int, W: int, seed: int, scene: str = "random",
                       out_hw=None):
    """Pixel coordinates as the main path's warp gets them (``ops.warp``'s
    own geometry, KITTI intrinsics): the target's pixels back-projected and
    projected into a reference frame of (H, W). ``scene='random'``: the
    target is (H, W), its depth 1 / disparity with a random disparity per
    pixel in the head's range, the pose small and random. ``'road'``: the
    target is ``out_hw`` (default (H, W)), its depth a road scene's (80 m
    above the horizon, falling to ~6 m at the bottom row, times 1 + 5%
    noise), the pose a forward drive (0.5 m towards the scene: a zoom that
    throws the bottom corners out of view) with a small sideways move and
    yaw. ``'road_near'``: the same with 5% of the pixels at a tenth of their
    depth, thrown far from their neighbours."""
    from supervised_dispnet_tpu_torch.ops import warp as wp

    g = torch.Generator().manual_seed(seed)
    if scene == "random":
        disp = 10.0 * torch.sigmoid(torch.randn(B, H, W, generator=g)) + 0.01
        pose = 0.02 * torch.randn(B, 6, generator=g)
        K = _kitti_k(torch, B, H, W)
        cam = wp.pixel2cam(1.0 / disp, torch.linalg.inv(K))
        proj = K @ wp.pose_vec2mat(pose)
        x, y, _ = wp.cam2pixel(cam, proj[:, :, :3], proj[:, :, 3:])
        return x, y
    Ho, Wo = out_hw or (H, W)
    rows = torch.arange(Ho, dtype=torch.float32)[:, None].expand(Ho, Wo)
    fy, cy = 246.3 * Ho / 128, 64.0 * Ho / 128
    depth = (1.65 * fy / (rows - cy).clamp(min=0.5)).clamp(3.0, 80.0)
    depth = depth * (1.0 + 0.05 * torch.randn(B, Ho, Wo, generator=g))
    if scene == "road_near":
        near = torch.rand(B, Ho, Wo, generator=g) < 0.05
        depth = torch.where(near, 0.1 * depth, depth)
    pose = torch.tensor([0.05, 0.0, -0.5, 0.0, 0.0, 0.0]) + torch.cat(
        [0.01 * torch.randn(B, 3, generator=g), 0.003 * torch.randn(B, 3, generator=g)], 1)
    x, y, _ = wp.warp_coords(depth, pose, _kitti_k(torch, B, H, W), (H, W),
                             tgt_intrinsics=_kitti_k(torch, B, Ho, Wo))
    return x, y


def _warp_case(torch, rng, shape, coords="projection", out_hw=None, seed=0,
               device="cuda"):
    """img (B, H, W, C) uniform in [-1, 1] (normalised images), coordinates
    (B, Ho, Wo), an upstream gradient (B, Ho, Wo, C) uniform in [-1, 1];
    all on the card. ``coords='random'`` spreads them over three times the
    image, most out of bounds; 'projection' (a random per-pixel depth, Ho,
    Wo = H, W), 'road' and 'road_near' are ``_projection_coords``' scenes."""
    B, H, W, C = shape
    Ho, Wo = out_hw or (H, W)
    if coords == "projection":
        x, y = _projection_coords(torch, B, H, W, seed)
    elif coords in ("road", "road_near"):
        x, y = _projection_coords(torch, B, H, W, seed, coords, out_hw)
    else:
        x = torch.from_numpy(rng.uniform(-W, 2 * W, (B, Ho, Wo)).astype(np.float32))
        y = torch.from_numpy(rng.uniform(-H, 2 * H, (B, Ho, Wo)).astype(np.float32))
    img = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    g = rng.uniform(-1.0, 1.0, (B, *x.shape[1:], C)).astype(np.float32)
    dev = torch.device(device)
    return (torch.from_numpy(img).to(dev), x.contiguous().to(dev), y.contiguous().to(dev),
            torch.from_numpy(g).to(dev))


def _plain_warp_grads(torch, img, x, y, g, mode):
    """Value and (dimg, dx, dy) of the plain sampler by autograd."""
    from supervised_dispnet_tpu_torch.ops.sampling import bilinear_sample

    ins = [t.clone().requires_grad_(True) for t in (img, x, y)]
    out = bilinear_sample(*ins, mode)
    return out.detach(), torch.autograd.grad(out, ins, g)


def warp_phase(torch, device: str = "cuda") -> dict:
    """The three warp kernels against the plain sampler on the card, for the
    values and every gradient each kernel forms. Tolerances: the sample, dx
    and dy rtol 1e-5 / atol 1e-6 (unit-scale images and upstream gradient;
    the kernel sums the same products in another order); dimg rtol 1e-4 /
    atol 1e-5 (atomics, in shared memory and in dimg, change the order of
    its sums from run to run); the coordinate-only backward's dx, dy
    bit-equal to the full backward's. The cases: a random per-pixel depth's
    projection, random coordinates mostly out of bounds, ragged shapes, and
    the ones the image+coordinate backward's shared window has to survive
    (a road scene's smooth depth, whose tiles' corners fit a window; its
    border mode, where the pixels thrown out of view pile onto the edges;
    near points thrown far; an output of another size, whose tiles do not
    divide it; C = 1 and 4). Then times at the main path's shape: CUDA
    events of each call, and the image+coordinate backward's device time
    (kernel and memset) on four kinds of coordinates, with
    ``F.grid_sample``'s beside."""
    from supervised_dispnet_tpu_torch.ops.cuda import warp as kw

    rng = np.random.default_rng(3)
    B, H, W = MAIN_SHAPE
    main = f"main ({B},{H},{W},3)"
    cases = {
        f"{main} projection zeros": ((B, H, W, 3), "projection", None, "zeros"),
        f"{main} projection border": ((B, H, W, 3), "projection", None, "border"),
        f"{main} random out of bounds zeros": ((B, H, W, 3), "random", None, "zeros"),
        "C=1 (2,64,208,1) random border": ((2, 64, 208, 1), "random", None, "border"),
        "ragged (3,37,53,3) projection zeros": ((3, 37, 53, 3), "projection", None, "zeros"),
        "ragged (3,37,53,3) -> (19,29) random border": ((3, 37, 53, 3), "random", (19, 29),
                                                        "border"),
        f"{main} road zeros": ((B, H, W, 3), "road", None, "zeros"),
        f"{main} road border, piles on the edges": ((B, H, W, 3), "road", None, "border"),
        f"{main} road, 5% near points thrown far, zeros": ((B, H, W, 3), "road_near", None,
                                                           "zeros"),
        f"{main} -> (100,300) road, ragged tiles, border": ((B, H, W, 3), "road", (100, 300),
                                                            "border"),
        f"C=1 ({B},{H},{W},1) road border": ((B, H, W, 1), "road", None, "border"),
        f"C=4 ({B},{H},{W},4) road near points zeros": ((B, H, W, 4), "road_near", None,
                                                         "zeros"),
    }
    err = {"warp_fwd": 0.0, "warp_bwd": 0.0, "warp_bwd_coords": 0.0}
    for i, (name, (shape, coords, out_hw, mode)) in enumerate(cases.items()):
        img, x, y, g = _warp_case(torch, rng, shape, coords, out_hw, seed=10 + i,
                                  device=device)
        out_k = kw.warp_forward(img, x, y, mode)
        dimg_k, dx_k, dy_k = kw.warp_backward(img, x, y, g, mode)
        dx_c, dy_c = kw.warp_backward_coords(img, x, y, g, mode)
        out_p, (dimg_p, dx_p, dy_p) = _plain_warp_grads(torch, img, x, y, g, mode)
        torch.cuda.synchronize()
        checks = {
            "out": torch.allclose(out_k, out_p, rtol=1e-5, atol=1e-6),
            "dx": torch.allclose(dx_k, dx_p, rtol=1e-5, atol=1e-6),
            "dy": torch.allclose(dy_k, dy_p, rtol=1e-5, atol=1e-6),
            "dimg": torch.allclose(dimg_k, dimg_p, rtol=1e-4, atol=1e-5),
            "coords-only == full": torch.equal(dx_c, dx_k) and torch.equal(dy_c, dy_k),
            "finite": bool(torch.isfinite(out_k).all() and torch.isfinite(dx_k).all()
                           and torch.isfinite(dy_k).all() and torch.isfinite(dimg_k).all()),
        }
        e_f = float((out_k - out_p).abs().max())
        e_c = max(float((dx_k - dx_p).abs().max()), float((dy_k - dy_p).abs().max()))
        e_i = float((dimg_k - dimg_p).abs().max())
        err["warp_fwd"] = max(err["warp_fwd"], e_f)
        err["warp_bwd"] = max(err["warp_bwd"], e_c, e_i)
        err["warp_bwd_coords"] = max(err["warp_bwd_coords"], e_c)
        inb = float(((x >= 0) & (x <= shape[2] - 1) & (y >= 0) & (y <= shape[1] - 1))
                    .float().mean())
        print(f"  warp {name}: {inb:.1%} of coords in bounds; max abs err out {e_f:.3g}, "
              f"dx/dy {e_c:.3g}, dimg {e_i:.3g}", flush=True)
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"warp kernels disagree with the plain sampler on "
                                 f"{name}: {bad}")

    # timings at the main path's finest scale (zeros, projection coordinates)
    F = torch.nn.functional
    img, x, y, g = _warp_case(torch, rng, (B, H, W, 3), seed=1, device=device)
    P, n_img = x.numel(), img.numel()
    req = [t.clone().requires_grad_(True) for t in (img, x, y)]
    from supervised_dispnet_tpu_torch.ops.sampling import bilinear_sample
    out_full = bilinear_sample(req[0], req[1], req[2], "zeros")
    out_coords = bilinear_sample(img, req[1], req[2], "zeros")
    # the library: F.grid_sample(align_corners=True) on normalised
    # coordinates computes the same function, NCHW
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([x / (W - 1) * 2 - 1, y / (H - 1) * 2 - 1], dim=-1)
    lib_in = img_nchw.clone().requires_grad_(True)
    lib_grid = grid.clone().requires_grad_(True)
    lib_full = F.grid_sample(lib_in, lib_grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)
    lib_coords = F.grid_sample(img_nchw, lib_grid, mode="bilinear", padding_mode="zeros",
                               align_corners=True)
    g_nchw = g.permute(0, 3, 1, 2).contiguous()
    # atol: the normalisation's round trip moves x by ~ulp(400) = 3e-5 px,
    # and a unit-scale noise image changes by up to ~2 per px
    if not torch.allclose(lib_full.permute(0, 2, 3, 1), out_full, rtol=1e-5, atol=1e-3):
        raise AssertionError("F.grid_sample(align_corners=True) is not the same function")
    t = {
        "fwd": cuda_ms(torch, lambda: kw.warp_forward(img, x, y)),
        "fwd_plain": cuda_ms(torch, lambda: bilinear_sample(img, x, y)),
        "fwd_lib": cuda_ms(torch, lambda: F.grid_sample(
            img_nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True)),
        "bwd": cuda_ms(torch, lambda: kw.warp_backward(img, x, y, g)),
        "bwd_plain": cuda_ms(torch, lambda: torch.autograd.grad(
            out_full, req, g, retain_graph=True)),
        "bwd_lib": cuda_ms(torch, lambda: torch.autograd.grad(
            lib_full, (lib_in, lib_grid), g_nchw, retain_graph=True)),
        "coords": cuda_ms(torch, lambda: kw.warp_backward_coords(img, x, y, g)),
        "coords_plain": cuda_ms(torch, lambda: torch.autograd.grad(
            out_coords, req[1:], g, retain_graph=True)),
        "coords_lib": cuda_ms(torch, lambda: torch.autograd.grad(
            lib_coords, lib_grid, g_nchw, retain_graph=True)),
    }
    # device time: the image+coordinate backward (its kernel and the memset
    # that zeroes dimg) on four kinds of coordinates; F.grid_sample's calls
    # (every device event of a call) beside
    bwd_k = "warp_backward_kernel"
    dev, lib_dev = {}, {}
    for name, (coords, mode) in {"projection zeros": ("projection", "zeros"),
                                 "road zeros": ("road", "zeros"),
                                 "random out of bounds zeros": ("random", "zeros"),
                                 "road border": ("road", "border")}.items():
        args = ((img, x, y, g) if name == "projection zeros" else
                _warp_case(torch, rng, (B, H, W, 3), coords, seed=2, device=device))
        got = launch_device_us(torch, lambda a=args, m=mode: kw.warp_backward(*a, m),
                               (bwd_k, "Memset"))
        dev[name] = {"kernel_us": got[bwd_k], "memset_us": got["Memset"]}
    for key, fn in (("fwd", lambda: F.grid_sample(img_nchw, grid, mode="bilinear",
                                                   padding_mode="zeros", align_corners=True)),
                    ("bwd", lambda: torch.autograd.grad(lib_full, (lib_in, lib_grid), g_nchw,
                                                        retain_graph=True)),
                    ("coords", lambda: torch.autograd.grad(lib_coords, lib_grid, g_nchw,
                                                           retain_graph=True))):
        got = device_us(torch, fn, [""], reps=100)[""]
        lib_dev[key] = {"us": got[0] * got[1], "events": got[1]}
    # the least each must move (img, x, y, g read once, outputs written
    # once, f32) and do (~20 flops a pixel of corner setup, ~9 a channel of
    # blend, ~14 a channel of dx/dy and 8 of dimg weights)
    C = 3
    bounds = {
        "warp_fwd": bound_ms(4 * (n_img + 2 * P + P * C), P * (20 + 9 * C)),
        "warp_bwd": bound_ms(4 * (n_img + 2 * P + P * C + n_img + 2 * P),
                             P * (20 + 22 * C)),
        "warp_bwd_coords": bound_ms(4 * (n_img + 2 * P + P * C + 2 * P), P * (20 + 14 * C)),
    }
    print(f"  warp {main}: fwd kernel_ms {t['fwd']:.5f} plain_ms "
          f"{t['fwd_plain']:.5f} grid_sample_ms {t['fwd_lib']:.5f}; bwd kernel_ms "
          f"{t['bwd']:.5f} plain_ms {t['bwd_plain']:.5f} grid_sample_ms {t['bwd_lib']:.5f}; "
          f"coords bwd kernel_ms {t['coords']:.5f} plain_ms {t['coords_plain']:.5f} "
          f"grid_sample_ms {t['coords_lib']:.5f}; bound_us "
          + ", ".join(f"{k} {v[0] * 1e3:.3f}" for k, v in bounds.items()), flush=True)
    bwd_bound_us = bounds["warp_bwd"][0] * 1e3
    for name, d in dev.items():
        print(f"  warp bwd {main} {name}: device {d['kernel_us']:.2f} us kernel + "
              f"{d['memset_us']:.2f} us memset, one each a call; bound {bwd_bound_us:.3f} "
              f"us, {bwd_bound_us / d['kernel_us']:.1%} of it (kernel alone)", flush=True)
    print(f"  warp {main} F.grid_sample device us a call (every event): "
          + "; ".join(f"{k} {v['us']:.2f} ({v['events']:g} events)" for k, v in lib_dev.items()),
          flush=True)
    src = "supervised_dispnet_tpu_torch/csrc/warp.cu"
    out = {
        name: {"name": name, "route": "cuda", "source": src, "replaces": f"{TPU_WARP}:{line}",
               "max_abs_err": err[name], "ms": t[key], "plain_ms": t[f"{key}_plain"],
               "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
               "library_ms": t[f"{key}_lib"], "library_device_us": lib_dev[key]["us"]}
        for name, key, line in (("warp_fwd", "fwd", 114), ("warp_bwd", "bwd", 150),
                                ("warp_bwd_coords", "coords", 197))
    }
    out["warp_bwd"].update(device_us=dev["projection zeros"]["kernel_us"],
                           memset_us=dev["projection zeros"]["memset_us"],
                           device_us_by_case=dev)
    return out


def _step_problems(torch, rng, device: str = "cuda", seed: int = 30) -> list:
    """The self-supervised step's 8 sampling problems: 4 scales x 2 refs of
    the main path (128x416, B=4, halved per scale), C=3, coordinates from a
    projection at each scale; (img, x, y, g) each."""
    B, H, W = MAIN_SHAPE
    return [_warp_case(torch, rng, (B, H >> s, W >> s, 3), seed=seed + 2 * s + r,
                       device=device)
            for s in range(4) for r in range(2)]


def _group_agrees(torch, kw, name: str, probs: list, mode: str) -> tuple[float, float]:
    """One group through the grouped forward and coordinate-only backward,
    held problem by problem against the plain sampler (out, dx, dy rtol 1e-5
    / atol 1e-6) and against the single-problem kernels (bit for bit: the
    same kernels, the same arithmetic); the same group through the autograd
    Function (bit for bit with the direct calls); one launch a way per
    ``MAX_PROBLEMS`` problems. Returns the largest errors (out, dx/dy)."""
    imgs, xs, ys, gs = (list(t) for t in zip(*probs))
    n = len(probs)
    counters = ("warp_fwd_launches", "warp_bwd_coords_launches", "warp_fwd_problems",
                "warp_bwd_coords_problems")
    before = [getattr(kw, c) for c in counters]
    outs = kw.warp_forward_many(imgs, xs, ys, mode)
    grads = kw.warp_backward_coords_many(imgs, xs, ys, gs, mode)
    counted = [getattr(kw, c) - b for c, b in zip(counters, before)]
    want = [-(-n // kw.MAX_PROBLEMS)] * 2 + [n, n]
    reqs = [t.clone().requires_grad_(True) for t in xs + ys]
    outs_a = kw.bilinear_sample_many_cuda(imgs, reqs[:n], reqs[n:], mode)
    grads_a = torch.autograd.grad(outs_a, reqs, gs)
    err_f = err_c = 0.0
    bad = [] if counted == want else [f"launches {counted} != {want}"]
    for k, (img, x, y, g) in enumerate(probs):
        out_p, (_, dx_p, dy_p) = _plain_warp_grads(torch, img, x, y, g, mode)
        out_1 = kw.warp_forward(img, x, y, mode)
        dx_1, dy_1 = kw.warp_backward_coords(img, x, y, g, mode)
        (dx, dy), out = grads[k], outs[k]
        torch.cuda.synchronize()
        checks = {
            "out": torch.allclose(out, out_p, rtol=1e-5, atol=1e-6),
            "dx": torch.allclose(dx, dx_p, rtol=1e-5, atol=1e-6),
            "dy": torch.allclose(dy, dy_p, rtol=1e-5, atol=1e-6),
            "== single": (torch.equal(out, out_1) and torch.equal(dx, dx_1)
                          and torch.equal(dy, dy_1)),
            "== autograd": (torch.equal(out, outs_a[k]) and torch.equal(dx, grads_a[k])
                            and torch.equal(dy, grads_a[n + k])),
            "finite": bool(torch.isfinite(out).all() and torch.isfinite(dx).all()
                           and torch.isfinite(dy).all()),
        }
        bad += [f"problem {k} {tuple(img.shape)}: {c}" for c, ok in checks.items() if not ok]
        err_f = max(err_f, float((out - out_p).abs().max()))
        err_c = max(err_c, float((dx - dx_p).abs().max()), float((dy - dy_p).abs().max()))
    print(f"  warp group {name}: {n} problems, {counted[0]} + {counted[1]} launches; max "
          f"abs err out {err_f:.3g}, dx/dy {err_c:.3g}; bit-equal to the single-problem "
          f"kernels and to the autograd path: {not bad}", flush=True)
    if bad:
        raise AssertionError(f"grouped warp kernels disagree on {name}: {bad}")
    return err_f, err_c


def device_us(torch, fn, names, reps: int = 20) -> dict:
    """Device time of the kernels named (by substring) in ``names`` over
    ``reps`` calls of ``fn`` under ``torch.profiler``: {name: (us a launch,
    launches a call)}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
        count = sum(e.count for e in ev)
        out[name] = (sum(e.self_device_time_total for e in ev) / max(count, 1), count / reps)
    return out


def launch_device_us(torch, fn, kernels, reps: int = 100, tries: int = 3) -> dict:
    """Device us a launch of each of ``kernels`` (by substring) in a call of
    ``fn``, from a profile of ``reps`` calls in which each rounds to one
    event a call and no other device event shows (the profiler can drop
    events); profiled again up to ``tries`` times, then raises."""
    for _ in range(tries):
        got = device_us(torch, fn, [*kernels, ""], reps=reps)
        every = got.pop("")[1]
        counts = [n for _, n in got.values()]
        if all(round(n) == 1 for n in counts) and abs(every - sum(counts)) < 1e-9:
            return {k: v[0] for k, v in got.items()}
        print(f"    the profile shows {got} of {every:g} device events a call; again",
              flush=True)
    raise AssertionError(f"no profile with one event a call of each of {kernels}: {got}")


def host_us(torch, fn, reps: int = 500) -> float:
    """Host time of one call of ``fn`` (the enqueue, not the device's
    work), by the host clock over ``reps`` calls after 50 of warm-up."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def warp_call_breakdown(torch, probs: list) -> dict:
    """Where the host's time of a call goes (host clock; each step of the
    wrapper timed alone). The single-problem forward at the finest scale:
    the checks, the stream lookup, the output's allocation, the data
    pointers, the ``ctypes`` call (which launches the kernel), the counter's
    error check, the whole wrapper, the autograd Function around it, and
    ``F.grid_sample`` beside it. The grouped forward over the step's 8
    problems: the checks, the one allocation for all outputs, the pointers,
    the plan and the packed table, the ``ctypes`` call, the whole wrapper,
    the grouped backward's wrapper, and the autograd path."""
    from supervised_dispnet_tpu_torch.ops.cuda import _build
    from supervised_dispnet_tpu_torch.ops.cuda import warp as kw

    F = torch.nn.functional
    img, x, y, _ = probs[0]
    index, shape = img.get_device(), kw._check_inputs(img, x, y)
    out = torch.empty((*x.shape, 3), dtype=torch.float32, device=img.device)
    lib, stream = kw._lib(), kw._stream(index)
    ptrs = (img.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr())
    xr, yr = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    H, W = img.shape[1:3]
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([x / (W - 1) * 2 - 1, y / (H - 1) * 2 - 1], dim=-1)
    single = {
        "checks": lambda: (kw._border("zeros"), kw._check_inputs(img, x, y)),
        "stream": lambda: kw._stream(index),
        "alloc": lambda: torch.empty((*x.shape, 3), dtype=torch.float32, device=img.device),
        "pointers": lambda: (img.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr()),
        "ctypes": lambda: lib.warp_forward(*ptrs, *shape, 0, index, stream),
        "check": lambda: _build.check(lib, "warp", "warp_forward", 0),
        "wrapper": lambda: kw.warp_forward(img, x, y),
        "autograd_function": lambda: kw._WarpFunction.apply(img, xr, yr, "zeros", False),
        "grid_sample": lambda: F.grid_sample(img_nchw, grid, mode="bilinear",
                                             padding_mode="zeros", align_corners=True),
    }
    imgs, xs, ys, gs = (list(t) for t in zip(*probs))
    xsr = [t.clone().requires_grad_(True) for t in xs]
    ysr = [t.clone().requires_grad_(True) for t in ys]
    shapes, _ = kw._check_group(imgs, xs, ys)
    out_shapes = [(*a.shape, 3) for a in xs]
    outs = kw._empty_many(out_shapes, img.device)
    pointers = [(i.data_ptr(), a.data_ptr(), b.data_ptr(), 0, o.data_ptr(), 0, 0)
                for i, a, b, o in zip(imgs, xs, ys, outs)]
    ((table, n),) = kw._tables(shapes, pointers)
    group = {
        "checks": lambda: kw._check_group(imgs, xs, ys),
        "alloc": lambda: kw._empty_many(out_shapes, img.device),
        "pointers": lambda: [(i.data_ptr(), a.data_ptr(), b.data_ptr(), 0, o.data_ptr(), 0, 0)
                             for i, a, b, o in zip(imgs, xs, ys, outs)],
        "plan_and_table": lambda: list(kw._tables(shapes, pointers)),
        "ctypes": lambda: lib.warp_forward_many(table, n, 0, index, stream),
        "wrapper": lambda: kw.warp_forward_many(imgs, xs, ys),
        "coords_wrapper": lambda: kw.warp_backward_coords_many(imgs, xs, ys, gs),
        "autograd_fwd": lambda: kw.bilinear_sample_many_cuda(imgs, xsr, ysr),
    }
    us = {"single": {k: host_us(torch, f) for k, f in single.items()},
          "group_8": {k: host_us(torch, f) for k, f in group.items()}}
    us["single"]["autograd_overhead"] = (us["single"]["autograd_function"]
                                         - us["single"]["wrapper"])
    for name, parts in us.items():
        print(f"  warp {name} forward call, host us: "
              + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()), flush=True)
    return us


def warp_group_phase(torch, device: str = "cuda") -> dict:
    """The grouped warp kernels (``warp_forward_many``,
    ``warp_backward_coords_many``) on three groups, each against the plain
    sampler and the single-problem kernels (``_group_agrees``): the
    self-supervised step's 8 problems at the main path's shape in both
    padding modes; a ragged group of mixed shapes (C=1, a (3, 37, 53) ->
    (19, 29) problem, a 5x7 image); 20 problems, above ``MAX_PROBLEMS``
    (two launches a way); and what the entries refuse on the card (a CPU
    tensor in a CUDA group, float64, a non-contiguous image, unequal
    lists), with no launch counted. Then, over the step's 8 problems: CUDA-event
    times of the grouped calls, of 8 single-problem calls, of 8 plain
    samples and of 8 ``F.grid_sample`` calls (the yardstick), forward and
    coordinate-only backward; the device time of the grouped launch and of
    the single launches scale by scale (profiler); the group's bound; and
    the single call's host breakdown."""
    from supervised_dispnet_tpu_torch.ops.cuda import warp as kw
    from supervised_dispnet_tpu_torch.ops.sampling import bilinear_sample

    rng = np.random.default_rng(9)
    B, H, W = MAIN_SHAPE
    step = _step_problems(torch, rng, device)

    def case(shape, coords="random", out_hw=None, seed=0):
        return _warp_case(torch, rng, shape, coords, out_hw, seed=seed, device=device)

    groups = {
        f"selfsup step 4 scales x 2 refs ({B},{H},{W},3) zeros": (step, "zeros"),
        f"selfsup step 4 scales x 2 refs ({B},{H},{W},3) border": (step, "border"),
        "ragged mixed shapes border": ([
            case((B, H, W, 3), "projection", seed=40), case((3, 37, 53, 3), out_hw=(19, 29)),
            case((2, 64, 208, 1)), case((1, 5, 7, 3), out_hw=(3, 4)),
            case((3, 37, 53, 3), "projection", seed=41)], "border"),
        "20 problems, above MAX_PROBLEMS, zeros": ([
            case((1 + k % 3, 9 + 4 * k, 13 + 7 * k, 1 if k % 5 == 0 else 3),
                 out_hw=(5 + k, 6 + 3 * k)) for k in range(20)], "zeros"),
    }
    err_f = err_c = 0.0
    for name, (probs, mode) in groups.items():
        e_f, e_c = _group_agrees(torch, kw, name, probs, mode)
        err_f, err_c = max(err_f, e_f), max(err_c, e_c)

    # what the grouped entries refuse on the card, before any launch
    img, x, y, g = step[0]
    refusals = {
        "a CPU x in a group on the card": (ValueError, lambda: kw.warp_forward_many(
            [img, img], [x, x.cpu()], [y, y])),
        "a float64 y": (TypeError, lambda: kw.warp_forward_many([img], [x], [y.double()])),
        "a non-contiguous image": (ValueError, lambda: kw.warp_forward_many(
            [img.transpose(1, 2)], [x], [y])),
        "a float64 g": (TypeError, lambda: kw.warp_backward_coords_many(
            [img], [x], [y], [g.double()])),
        "fewer x than images": (ValueError, lambda: kw.warp_backward_coords_many(
            [img, img], [x], [y, y], [g, g])),
    }
    counters = ("warp_fwd_launches", "warp_bwd_coords_launches", "warp_fwd_problems",
                "warp_bwd_coords_problems")
    before = [getattr(kw, c) for c in counters]
    for name, (exc, call) in refusals.items():
        try:
            call()
        except exc:
            continue
        raise AssertionError(f"the grouped warp entries took {name}")
    if [getattr(kw, c) for c in counters] != before:
        raise AssertionError("a refused group moved a warp counter")
    print(f"  warp group refusals: {', '.join(refusals)}; no launch counted", flush=True)

    # timings over the step's 8 problems (zeros, projection coordinates)
    F = torch.nn.functional
    imgs, xs, ys, gs = (list(t) for t in zip(*step))
    xr = [t.clone().requires_grad_(True) for t in xs]
    yr = [t.clone().requires_grad_(True) for t in ys]
    plain = [bilinear_sample(i, a, b) for i, a, b in zip(imgs, xr, yr)]
    # the library: F.grid_sample(align_corners=True) on each problem's
    # normalised coordinates, NCHW
    nchw = [i.permute(0, 3, 1, 2).contiguous() for i in imgs]
    grids = [torch.stack([a / (i.shape[2] - 1) * 2 - 1, b / (i.shape[1] - 1) * 2 - 1], dim=-1)
             .requires_grad_(True) for i, a, b in zip(imgs, xs, ys)]
    lib = [F.grid_sample(i, gr, mode="bilinear", padding_mode="zeros", align_corners=True)
           for i, gr in zip(nchw, grids)]
    g_nchw = [g.permute(0, 3, 1, 2).contiguous() for g in gs]
    for a, b in zip(lib, plain):  # atol: as in warp_phase
        if not torch.allclose(a.permute(0, 2, 3, 1), b, rtol=1e-5, atol=1e-3):
            raise AssertionError("F.grid_sample(align_corners=True) is not the same function")
    t = {
        "fwd": cuda_ms(torch, lambda: kw.warp_forward_many(imgs, xs, ys)),
        "fwd_single": cuda_ms(torch, lambda: [kw.warp_forward(i, a, b)
                                              for i, a, b in zip(imgs, xs, ys)]),
        "fwd_plain": cuda_ms(torch, lambda: [bilinear_sample(i, a, b)
                                             for i, a, b in zip(imgs, xs, ys)]),
        "fwd_lib": cuda_ms(torch, lambda: [F.grid_sample(
            i, gr, mode="bilinear", padding_mode="zeros", align_corners=True)
            for i, gr in zip(nchw, grids)]),
        "coords": cuda_ms(torch, lambda: kw.warp_backward_coords_many(imgs, xs, ys, gs)),
        "coords_single": cuda_ms(torch, lambda: [kw.warp_backward_coords(i, a, b, g)
                                                 for i, a, b, g in step]),
        "coords_plain": cuda_ms(torch, lambda: torch.autograd.grad(
            plain, xr + yr, gs, retain_graph=True)),
        "coords_lib": cuda_ms(torch, lambda: torch.autograd.grad(
            lib, grids, g_nchw, retain_graph=True)),
    }
    # the least the group must move (each problem's img, x, y (and g) read
    # once, out (dx, dy) written once, f32) and do (as in warp_phase)
    n_img = sum(i.numel() for i in imgs)
    P = sum(a.numel() for a in xs)
    bounds = {"warp_fwd_group": bound_ms(4 * (n_img + 2 * P + 3 * P), P * (20 + 9 * 3)),
              "warp_bwd_coords_group": bound_ms(4 * (n_img + 2 * P + 3 * P + 2 * P),
                                                P * (20 + 14 * 3))}
    print(f"  warp group step (8 problems): fwd grouped_ms {t['fwd']:.5f} single_x8_ms "
          f"{t['fwd_single']:.5f} plain_x8_ms {t['fwd_plain']:.5f} grid_sample_x8_ms "
          f"{t['fwd_lib']:.5f}; coords bwd grouped_ms {t['coords']:.5f} single_x8_ms "
          f"{t['coords_single']:.5f} plain_ms {t['coords_plain']:.5f} grid_sample_x8_ms "
          f"{t['coords_lib']:.5f}; bound_us "
          + ", ".join(f"{k} {v[0] * 1e3:.3f}" for k, v in bounds.items()), flush=True)

    # device time: the single launches scale by scale, then the grouped ones
    fwd_k, bwd_k = "warp_forward_group_kernel", "warp_backward_coords_group_kernel"
    single = []
    for s in range(4):
        pair = step[2 * s:2 * s + 2]
        d = device_us(torch, lambda: [(kw.warp_forward(i, a, b), kw.warp_backward_coords(
            i, a, b, g)) for i, a, b, g in pair], (fwd_k, bwd_k))
        single.append({"scale": s, "shape": list(pair[0][0].shape),
                       "fwd_us": d[fwd_k][0], "coords_us": d[bwd_k][0]})
    d = device_us(torch, lambda: (kw.warp_forward_many(imgs, xs, ys),
                                  kw.warp_backward_coords_many(imgs, xs, ys, gs)),
                  (fwd_k, bwd_k))
    dev = {"fwd": d[fwd_k][0], "coords": d[bwd_k][0],
           "fwd_single_sum": sum(2 * r["fwd_us"] for r in single),
           "coords_single_sum": sum(2 * r["coords_us"] for r in single)}
    print("  warp single launches, device us a launch by scale: " + "; ".join(
        f"scale {r['scale']} {tuple(r['shape'])} fwd {r['fwd_us']:.2f} coords "
        f"{r['coords_us']:.2f}" for r in single), flush=True)
    for key, row, kernel in (("fwd", "warp_fwd_group", fwd_k),
                             ("coords", "warp_bwd_coords_group", bwd_k)):
        singles, bound_us = dev[f"{key}_single_sum"], bounds[row][0] * 1e3
        print(f"  warp group {key}: device {dev[key]:.2f} us a launch, {d[kernel][1]:g} a "
              f"call; the 8 single launches {singles:.2f} us (grouped below them: "
              f"{dev[key] < singles}); bound {bound_us:.3f} us, {bound_us / dev[key]:.1%} "
              f"of it", flush=True)
    breakdown = warp_call_breakdown(torch, step)

    src = "supervised_dispnet_tpu_torch/csrc/warp.cu"
    return {
        name: {"name": name, "route": "cuda", "source": src, "replaces": f"{TPU_WARP}:{line}",
               "max_abs_err": err, "ms": t[key], "plain_ms": t[f"{key}_plain"],
               "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
               "library_ms": t[f"{key}_lib"], "problems": len(step),
               "device_us": dev[key], "single_x8_ms": t[f"{key}_single"],
               "single_device_us_sum": dev[f"{key}_single_sum"],
               "single_device_us_by_scale": [r[f"{key}_us"] for r in single],
               **({"host_us": breakdown} if key == "fwd" else {})}
        for name, key, line, err in (("warp_fwd_group", "fwd", 114, err_f),
                                     ("warp_bwd_coords_group", "coords", 197, err_c))
    }


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        return self.buf.write(s)

    def flush(self):
        self.out.flush()


def write_packed(root: Path, rng, H: int, W: int, n_train: int = 24,
                 n_val: int = 8, with_depth: bool = True) -> None:
    """A tiny packed dataset: random frames, ~10% sparse GT depth (or none),
    two scenes per split, KITTI-like intrinsics."""
    from supervised_dispnet_tpu_torch.data.packed import write_split

    K = np.array([[241.7, 0.0, W / 2], [0.0, 246.3, H / 2], [0.0, 0.0, 1.0]],
                 np.float32)
    for split, n in (("train", n_train), ("val", n_val)):
        images = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
        depth = rng.uniform(1.0, 80.0, (n, H, W)) * (rng.uniform(size=(n, H, W)) < 0.1)
        write_split(root / split, images, np.stack([K, K]),
                    [(0, n // 2), (n // 2, n)],
                    depth.astype(np.float32) if with_depth else None)


def slice_phase(torch, tmp: Path, card: str, device: str = "cuda") -> dict:
    """DispResNet-50 BerHu training through the CLI, as a user runs it."""
    from supervised_dispnet_tpu_torch.cli import train as train_cli
    from supervised_dispnet_tpu_torch.data.packed import PackedValidationSet
    from supervised_dispnet_tpu_torch.ops.cuda import losses as kl

    B, H, W = MAIN_SHAPE
    write_packed(tmp / "data", np.random.default_rng(1), H, W)
    argv = [str(tmp / "data"), "--network", "disp_res_50", "--loss", "berhu",
            "-b", str(B), "--epoch-size", "5", "--epochs", "1", "--with-gt",
            "--use-pallas-losses", "--device", device,
            "--checkpoints-dir", str(tmp / "ckpt"), "--name", "smoke"]
    tee = _Tee(sys.stdout)
    kl.berhu_fwd_launches = kl.berhu_bwd_launches = kl.berhu_fwd_problems = 0
    with contextlib.redirect_stdout(tee):
        trainer = train_cli.main(argv)
    torch.cuda.synchronize()
    launches = {"berhu_fwd": kl.berhu_fwd_launches, "berhu_bwd": kl.berhu_bwd_launches,
                "berhu_fwd_problems": kl.berhu_fwd_problems}
    steps = trainer.step
    print(f"  slice: {steps} steps; launches {launches}", flush=True)
    # the 4 scales of the multi-scale loss in one grouped launch each way a
    # step; validation runs no BerHu
    want = {"berhu_fwd": steps, "berhu_bwd": steps, "berhu_fwd_problems": 4 * steps}
    if steps < 5 or launches != want:
        raise AssertionError(f"expected launches {want} over {steps} steps (one grouped "
                             f"BerHu launch of 4 problems each way a step), got {launches}")
    text = tee.buf.getvalue()
    if "abs_rel=" not in text or "rmse=" not in text:
        raise AssertionError("validation printed no abs_rel / rmse")
    losses, epoch = _read_run(trainer, steps)
    if not all(math.isfinite(epoch[k]) for k in ("abs_rel", "rmse", "a1")):
        raise AssertionError(f"validation metrics not finite: {epoch}")

    val = PackedValidationSet(tmp / "data", uint8=True).get_batch(range(B))
    disp = trainer.predict(val["img"].astype(np.float32) / 255.0)
    lo, hi = np.float32(0.01), np.float32(10.01)  # the head's range
    if disp.shape != (B, H, W) or not ((disp >= lo) & (disp <= hi)).all():
        raise AssertionError(f"predict: shape {disp.shape}, range "
                             f"[{disp.min()}, {disp.max()}]")
    print(f"  predict: disparity {disp.shape} in [{disp.min():.4f}, "
          f"{disp.max():.4f}]", flush=True)

    timed = steady_step(torch, trainer, "DispResNet-50 BerHu", card)
    berhu = {r["kernel"]: r["calls_per_step"] for r in timed["profile"]["own_kernels"]
             if "berhu_" in r["kernel"]}
    if sorted(berhu.values()) != [1.0, 1.0] or not all(
            any(k in name for name in berhu) for k in OWN_KERNELS[:2]):
        raise AssertionError(f"the step's profile shows BerHu kernels {berhu}, not one "
                             f"grouped forward and one grouped backward a step")
    return {"launches": launches, "train_losses": losses,
            "val": {k: epoch[k] for k in ("abs_rel", "rmse", "a1")},
            "checkpoint": str(Path(trainer.cfg.save_path) / "dispnet_checkpoint.pth.tar"),
            **timed}


def steady_step(torch, trainer, label: str, card: str, reps: int = 20) -> dict:
    """The step the CLI ran, on one of its batches, timed by the host clock
    over ``reps`` steps after 3 of warm-up: in full fp32, the math mode the
    ``Trainer`` sets, and then with TF32 on for convolutions and matrix
    products, for comparison only; then profiled in fp32."""
    from supervised_dispnet_tpu_torch.utils.device import set_fp32_math

    B, H, W = MAIN_SHAPE
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the trainer left TF32 on: its step is not fp32")
    train_loader, _ = trainer.make_loaders()
    batches = iter(train_loader)
    batch = trainer.prep_train_batch(next(batches))
    batches.close()  # stops the loader's prefetch thread

    def timed() -> float:
        for _ in range(3):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    step_ms = timed()
    set_fp32_math(tf32=True)
    try:
        tf32_ms = timed()
    finally:
        set_fp32_math()
    print(f"  slice step: {label} {H}x{W} B={B} fp32 train step {step_ms:.3f} ms, "
          f"{B / step_ms * 1e3:.1f} img/s; with TF32 {tf32_ms:.3f} ms, "
          f"{B / tf32_ms * 1e3:.1f} img/s, on {card}", flush=True)
    return {"step_ms": step_ms, "step_ms_tf32": tf32_ms,
            "profile": profile_steps(torch, lambda: trainer.train_step(batch))}


def _read_run(trainer, steps: int) -> tuple[list, dict]:
    """Train losses (checked finite, one a step) and the epoch's record from
    the run's ``metrics.jsonl``."""
    events = [json.loads(line) for line in
              (Path(trainer.cfg.save_path) / "metrics.jsonl").read_text().splitlines()]
    losses = [e["loss"] for e in events if e["event"] == "train_iter"]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train losses not finite: {losses}")
    return losses, [e for e in events if e["event"] == "epoch"][0]


def selfsup_phase(torch, tmp: Path, card: str, device: str = "cuda") -> dict:
    """DispNetS + PoseExpNet self-supervised training through the CLI, as a
    user runs it, on a split without depth (validation without GT)."""
    from supervised_dispnet_tpu_torch.cli import train as train_cli
    from supervised_dispnet_tpu_torch.ops.cuda import warp as kw

    B, H, W = MAIN_SHAPE
    write_packed(tmp / "data", np.random.default_rng(4), H, W, with_depth=False)
    argv = [str(tmp / "data"), "--network", "dispnet", "--loss", "selfsup",
            "--sequence-length", "3", "-p", "1.0", "-m", "0.2", "-s", "0.1",
            "-b", str(B), "--epoch-size", "5", "--epochs", "1", "--use-pallas-warp",
            "--device", device, "--checkpoints-dir", str(tmp / "ckpt"), "--name", "smoke"]
    tee = _Tee(sys.stdout)
    counters = {"warp_fwd": "warp_fwd_launches", "warp_bwd": "warp_bwd_launches",
                "warp_bwd_coords": "warp_bwd_coords_launches",
                "warp_fwd_problems": "warp_fwd_problems",
                "warp_bwd_coords_problems": "warp_bwd_coords_problems"}
    for attr in counters.values():
        setattr(kw, attr, 0)
    with contextlib.redirect_stdout(tee):
        trainer = train_cli.main(argv)
    torch.cuda.synchronize()
    launches = {k: getattr(kw, attr) for k, attr in counters.items()}
    steps = trainer.step
    val_batches = len(trainer.make_loaders()[1])
    print(f"  selfsup slice: {steps} steps, {val_batches} validation batches; "
          f"launches {launches}", flush=True)
    # 4 scales x 2 refs in one grouped launch: a forward and a
    # coordinate-only backward per step, a forward per validation batch, 8
    # problems each; no image gradient
    want = {"warp_fwd": steps + val_batches, "warp_bwd": 0, "warp_bwd_coords": steps,
            "warp_fwd_problems": 8 * (steps + val_batches),
            "warp_bwd_coords_problems": 8 * steps}
    if steps < 5 or trainer.val_with_gt or launches != want:
        raise AssertionError(f"expected launches {want} over {steps} steps and "
                             f"{val_batches} validation batches without GT, got "
                             f"{launches} (val_with_gt {trainer.val_with_gt})")
    text = tee.buf.getvalue()
    if "photo_loss=" not in text:
        raise AssertionError("validation printed no photo_loss")
    losses, epoch = _read_run(trainer, steps)
    val = {k: epoch[k] for k in ("photo_loss", "exp_loss", "smooth_loss")}
    if not all(math.isfinite(v) for v in val.values()):
        raise AssertionError(f"validation losses not finite: {val}")
    for name in ("exp_pose_checkpoint.pth.tar", "dispnet_checkpoint.pth.tar"):
        if not (Path(trainer.cfg.save_path) / name).is_file():
            raise AssertionError(f"no {name} written")
    return {"launches": launches, "train_losses": losses, "val": val,
            "pose_checkpoint": str(Path(trainer.cfg.save_path) / "exp_pose_checkpoint.pth.tar"),
            **steady_step(torch, trainer, "DispNetS + PoseExpNet selfsup", card)}


def classification_phase(torch, tmp: Path, card: str, multiscale: bool = False,
                         device: str = "cuda") -> dict:
    """DispResNet-50 depth-as-classification training (64 bins) through the
    CLI, as the README runs it: 1 forward and 1 backward CE launch a step
    (4 + 4 with ``--multiscale-classification``), none in validation, which
    decodes the logits and computes no CE. The single-scale run is timed and
    profiled."""
    from supervised_dispnet_tpu_torch.cli import train as train_cli
    from supervised_dispnet_tpu_torch.data.packed import PackedValidationSet
    from supervised_dispnet_tpu_torch.ops.cuda import classification as kc

    B, H, W = MAIN_SHAPE
    write_packed(tmp / "data", np.random.default_rng(8), H, W)
    argv = [str(tmp / "data"), "--network", "disp_res_50", "--loss", "classification",
            "-b", str(B), "--epoch-size", "3" if multiscale else "5", "--epochs", "1",
            "--with-gt", "--use-pallas-losses", "--device", device,
            "--checkpoints-dir", str(tmp / "ckpt"), "--name", "smoke"]
    if multiscale:
        argv.append("--multiscale-classification")
    tee = _Tee(sys.stdout)
    kc.ce_fwd_launches = kc.ce_bwd_launches = 0
    with contextlib.redirect_stdout(tee):
        trainer = train_cli.main(argv)
    torch.cuda.synchronize()
    launches = {"ce_fwd": kc.ce_fwd_launches, "ce_bwd": kc.ce_bwd_launches}
    steps, per_step = trainer.step, 4 if multiscale else 1
    tag = "multi-scale " if multiscale else ""
    print(f"  classification {tag}slice: {steps} steps; launches {launches}", flush=True)
    if steps < (3 if multiscale else 5) or any(v != per_step * steps for v in launches.values()):
        raise AssertionError(f"expected {per_step} CE launches per step each way over "
                             f"{steps} steps and none in validation, got {launches}")
    text = tee.buf.getvalue()
    if "abs_rel=" not in text or "rmse=" not in text:
        raise AssertionError("validation printed no abs_rel / rmse")
    losses, epoch = _read_run(trainer, steps)
    val = {k: epoch[k] for k in ("abs_rel", "rmse", "a1")}
    if not all(math.isfinite(v) for v in val.values()):
        raise AssertionError(f"validation metrics not finite: {epoch}")

    imgs = PackedValidationSet(tmp / "data", uint8=True).get_batch(range(B))["img"]
    disp = trainer.predict(imgs.astype(np.float32) / 255.0)
    if disp.shape != (B, H, W) or not ((disp >= 1 / 80) & (disp <= 1.0)).all():
        raise AssertionError(f"predict: shape {disp.shape}, range "
                             f"[{disp.min()}, {disp.max()}], not in [1/80, 1]")
    print(f"  predict: disparity {disp.shape} in [{disp.min():.4f}, {disp.max():.4f}]",
          flush=True)
    out = {"launches": launches, "train_losses": losses, "val": val,
           "checkpoint": str(Path(trainer.cfg.save_path) / "dispnet_checkpoint.pth.tar")}
    if not multiscale:
        out.update(steady_step(torch, trainer, "DispResNet-50 classification (64 bins)", card))
        # every CE kernel in the profile is one of the two, and each rounds to
        # one a step (the profiler can drop an event; the launch counters
        # above hold the exact count)
        ce = {r["kernel"]: r["calls_per_step"] for r in out["profile"]["own_kernels"]
              if CE_KERNEL in r["kernel"]}
        if (sorted(sum(k in name for k in OWN_KERNELS[4:]) for name in ce) != [1, 1]
                or not all(any(k in name for name in ce) for k in OWN_KERNELS[4:])
                or not all(round(n) == 1 for n in ce.values())):
            raise AssertionError(f"the step's profile shows CE kernels {ce}, not one "
                                 f"forward and one backward a step")
    return out


EVAL_BATCH = 8  # the eval CLI's default --batch-size
EVAL_METRICS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def kernel_counters():
    """(module, counter) of every launch counter of the port's kernels."""
    from supervised_dispnet_tpu_torch.ops.cuda import classification as kc
    from supervised_dispnet_tpu_torch.ops.cuda import int8_conv as ki
    from supervised_dispnet_tpu_torch.ops.cuda import losses as kl
    from supervised_dispnet_tpu_torch.ops.cuda import warp as kw

    return [(m, a) for m in (kl, kw, kc, ki) for a in sorted(vars(m))
            if a.endswith(("_launches", "_problems"))]


def _tables_agree(a: dict, b: dict, rtol: float) -> tuple[bool, float]:
    """Each Eigen metric within rtol of the larger of the two (and 1e-9
    where both are ~0); also the largest relative difference."""
    worst, ok = 0.0, True
    for k in EVAL_METRICS:
        scale = max(abs(a[k]), abs(b[k]))
        worst = max(worst, abs(a[k] - b[k]) / max(scale, 1e-30))
        ok &= abs(a[k] - b[k]) <= rtol * scale + 1e-9
    return ok, worst


def _run_eval(tmp: Path, tree: Path, ckpt: str, name: str, *extra: str) -> dict:
    """``cli.test_disp.main`` on the synthetic tree as a user runs it;
    returns its table, its predictions and its wall seconds."""
    from supervised_dispnet_tpu_torch.cli import test_disp

    out = tmp / f"eval_{name}"
    t0 = time.perf_counter()
    results = test_disp.main([
        "--pretrained-dispnet", ckpt, "--network", "disp_res_50",
        "--dataset-dir", str(tree.parent), "--dataset-list", str(tree),
        "--img-height", str(MAIN_SHAPE[1]), "--img-width", str(MAIN_SHAPE[2]),
        "--batch-size", str(EVAL_BATCH), "--median-scaling", "--output-dir", str(out),
        *extra])
    wall = time.perf_counter() - t0
    if not (results["n_images"] > 0 and all(math.isfinite(results[k]) for k in EVAL_METRICS)):
        raise AssertionError(f"eval {name}: table not finite: {results}")
    preds = np.load(out / "predictions.npy", allow_pickle=True)
    print(f"  eval {name}: {len(preds)} frames in {wall:.3f} s; abs_rel "
          f"{results['abs_rel']:.6f} rmse {results['rmse']:.6f} a1 {results['a1']:.6f}",
          flush=True)
    return {"table": {k: results[k] for k in (*EVAL_METRICS, "n_images")},
            "wall_s": wall, "preds": [p.astype(np.float32) for p in preds]}


def _max_rel(a: list, b: list) -> float:
    return max(float(np.abs(x - y).max() / np.abs(y).max()) for x, y in zip(a, b))


def host_pipeline_s(tree: Path) -> dict:
    """The eval producer's host work for the tree, part by part: PNG decode
    (``read_image``, the native unfilter), the velodyne GT projection and the
    area resize to the network input."""
    from supervised_dispnet_tpu_torch.data.image_resize import resize_area
    from supervised_dispnet_tpu_torch.kitti_eval.depth_evaluation_utils import (
        generate_depth_map)
    from supervised_dispnet_tpu_torch.utils.image_io import read_image

    parts = {"decode_s": 0.0, "gt_s": 0.0, "resize_s": 0.0}
    for rel in tree.read_text().split():
        img_path = tree.parent / rel
        t0 = time.perf_counter()
        img = read_image(img_path)
        t1 = time.perf_counter()
        drive = img_path.parents[2]
        generate_depth_map(drive.parent, drive / "velodyne_points" / "data" /
                           f"{img_path.stem}.bin", img.shape[:2])
        t2 = time.perf_counter()
        resize_area(img.astype(np.float32) / 255.0, *MAIN_SHAPE[1:])
        t3 = time.perf_counter()
        parts["decode_s"] += t1 - t0
        parts["gt_s"] += t2 - t1
        parts["resize_s"] += t3 - t2
    return parts


def eval_forward_timing(torch, ckpt: str, card: str) -> dict:
    """The eval CLI's forward (model and 1 / disp) of DispResNet-50 at
    (8, 128, 416) in full fp32, unfused and fused: CUDA events over 50 calls
    after 5 of warm-up, the host's time to enqueue one forward on an idle
    card (mean of 10), then a profile of 5 calls. The unfused decoder
    upsamples with 5 ``upsample_bilinear2d`` launches a forward; the fused
    one must launch none."""
    from supervised_dispnet_tpu_torch.cli.test_disp import load_model

    B, (H, W) = EVAL_BATCH, MAIN_SHAPE[1:]
    x = (torch.rand(B, H, W, 3, generator=torch.Generator().manual_seed(12)) * 2 - 1).cuda()
    out = {}
    for name, fused in (("unfused", False), ("fused", True)):
        model = load_model(ckpt, "disp_res_50", fused_upsample=fused, device="cuda")

        def forward():
            with torch.inference_mode():
                return 1.0 / model(x)[0][..., 0]

        ms = cuda_ms(torch, forward, reps=50, warmup=5)
        enqueue = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        host_ms = sum(enqueue) / len(enqueue)
        print(f"  eval forward {name}: DispResNet-50 ({B}, 3, {H}, {W}) fp32 {ms:.3f} ms, "
              f"{B / ms * 1e3:.1f} img/s; the host enqueues one in {host_ms:.3f} ms; on "
              f"{card}", flush=True)
        prof = profile_steps(torch, forward, n=5, top=8, count=("upsample",))
        print(f"  eval forward {name}: upsample launches a forward "
              f"{prof['counts']['upsample']:g}", flush=True)
        if fused and prof["counts"]["upsample"]:
            raise AssertionError(f"the fused decoder launched upsample kernels: {prof}")
        out[name] = {"ms": ms, "img_per_s": B / ms * 1e3, "host_enqueue_ms": host_ms,
                     "profile": prof}
    return out


def kitti_tree(tmp: Path) -> Path:
    """A synthetic KITTI-raw tree of 2 drives of 8 frames at 375x1242, each
    with a 100k-point velodyne scan; returns its Eigen-format list."""
    from supervised_dispnet_tpu_torch.kitti_eval.synthetic import write_kitti_raw

    t0 = time.perf_counter()
    tree = write_kitti_raw(tmp / "kitti_raw", seed=11, drives=2, frames=8)
    print(f"  synthetic KITTI-raw tree of 16 frames in {time.perf_counter() - t0:.2f} s",
          flush=True)
    return tree


def eval_phase(torch, tmp: Path, card: str, tree: Path, ckpt: str, class_ckpt: str) -> dict:
    """The Eigen-split eval CLI (BASELINE config 2) on the synthetic tree,
    with the DispResNet-50 checkpoint that the supervised phase wrote, at
    128x416, batch 8, with median scaling (a model trained 5 steps has no
    metric scale). On the card, then with ``--device cpu``: each metric
    within rel 1e-3. The forward is in eval mode (BatchNorm's running
    statistics) in full fp32 on both, so none of the train step's ~2%
    gradient spread (ReLU flips under batch statistics) applies; 1e-3 is
    the train step's gradient tolerance, far above the forward's expected
    ~1e-5. Then ``--fused-upsample`` on the card, within rel 1e-4 of the
    unfused card run (the same function to float32 rounding), and
    ``--classification`` with the classification phase's checkpoint."""
    card_run = _run_eval(tmp, tree, ckpt, "card")
    cpu_run = _run_eval(tmp, tree, ckpt, "cpu", "--device", "cpu")
    fused_run = _run_eval(tmp, tree, ckpt, "card_fused", "--fused-upsample")
    class_run = _run_eval(tmp, tree, class_ckpt, "card_classification", "--classification")
    ok_cpu, cpu_rel = _tables_agree(card_run["table"], cpu_run["table"], 1e-3)
    ok_fused, fused_rel = _tables_agree(card_run["table"], fused_run["table"], 1e-4)
    pred_cpu, pred_fused = (_max_rel(card_run["preds"], r["preds"]) for r in (cpu_run, fused_run))
    print(f"  eval: card vs CPU table rel {cpu_rel:.3g} (limit 1e-3), predictions rel "
          f"{pred_cpu:.3g}; fused vs unfused table rel {fused_rel:.3g} (limit 1e-4), "
          f"predictions rel {pred_fused:.3g}", flush=True)
    if not (ok_cpu and ok_fused):
        raise AssertionError(f"eval tables disagree: card {card_run['table']}, CPU "
                             f"{cpu_run['table']}, fused {fused_run['table']}")
    host = host_pipeline_s(tree)
    print(f"  eval host work for 16 frames: {host}", flush=True)
    return {"tables": {n: r["table"] for n, r in (("card", card_run), ("cpu", cpu_run),
                                                  ("card_fused", fused_run),
                                                  ("card_classification", class_run))},
            "wall_s": {n: r["wall_s"] for n, r in (("card", card_run), ("cpu", cpu_run),
                                                   ("card_fused", fused_run),
                                                   ("card_classification", class_run))},
            "table_rel": {"card_vs_cpu": cpu_rel, "fused_vs_unfused": fused_rel},
            "pred_rel": {"card_vs_cpu": pred_cpu, "fused_vs_unfused": pred_fused},
            "host_16_frames": host,
            "forward": eval_forward_timing(torch, ckpt, card), "card": card}


def inference_phase(torch, tmp: Path, tree: Path, ckpt: str) -> dict:
    """The folder-inference CLI (BASELINE config 1) on the 8 PNGs of the
    synthetic tree's first drive, with disparity and depth PNGs and ``.npy``
    depths, on the card and on the CPU: the depths within rel 1e-3 of each
    other (the eval phase's limit), and every output written."""
    from supervised_dispnet_tpu_torch.cli import run_inference
    from supervised_dispnet_tpu_torch.kitti_eval.synthetic import DATE
    from supervised_dispnet_tpu_torch.utils.image_io import read_png

    frames = tree.parent / DATE / f"{DATE}_drive_0001_sync" / "image_02" / "data"
    stems = sorted(f.stem for f in frames.glob("*.png"))
    walls = {}
    for name, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        t0 = time.perf_counter()
        run_inference.main(["--pretrained", ckpt, "--network", "disp_res_50",
                            "--dataset-dir", str(frames), "--output-dir",
                            str(tmp / f"infer_{name}"), "--img-height", str(MAIN_SHAPE[1]),
                            "--img-width", str(MAIN_SHAPE[2]), "--save-npy", "--output-disp",
                            "--output-depth", *extra])
        walls[name] = time.perf_counter() - t0
    worst = 0.0
    for stem in stems:
        for kind in ("disp", "depth"):
            png = read_png(tmp / "infer_card" / f"{stem}_{kind}.png")
            if png.shape != (*MAIN_SHAPE[1:], 3):
                raise AssertionError(f"{stem}_{kind}.png has shape {png.shape}")
        card, cpu = (np.load(tmp / f"infer_{n}" / f"{stem}_depth.npy") for n in ("card", "cpu"))
        if card.shape != MAIN_SHAPE[1:] or not np.isfinite(card).all() or (card <= 0).any():
            raise AssertionError(f"{stem}_depth.npy: shape {card.shape}, range "
                                 f"[{card.min()}, {card.max()}]")
        worst = max(worst, float(np.abs(card - cpu).max() / np.abs(cpu).max()))
    print(f"  inference: {len(stems)} frames, card {walls['card']:.3f} s, CPU "
          f"{walls['cpu']:.3f} s; depth card vs CPU rel {worst:.3g} (limit 1e-3)", flush=True)
    if len(stems) != 8 or worst > 1e-3:
        raise AssertionError(f"inference: {len(stems)} frames, card vs CPU rel {worst}")
    return {"frames": len(stems), "wall_s": walls, "depth_rel_card_vs_cpu": worst}


POSE_BATCH = 32  # the pose CLI's default --batch-size


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def pose_phase(torch, tmp: Path, card: str, pose_ckpt: str) -> dict:
    """Odometry pose evaluation (A4) through ``cli.test_pose.main`` as a
    user runs it, with the self-supervised run's ``exp_pose`` checkpoint, on
    a synthetic sequence of 40 frames at 375x1242 read at 128x416, batch 32:
    on the card and with ``--device cpu``. ATE / RE means and stds within
    rel 1e-3 (the eval phase's limit), and the network's pose vectors too.
    Then the host's decode and resize seconds for the 40 frames, and the
    PoseExpNet forward's ms a batch at (32, 3, 128, 416) from CUDA events."""
    from supervised_dispnet_tpu_torch.cli import test_pose
    from supervised_dispnet_tpu_torch.data.image_resize import resize_area_uint8
    from supervised_dispnet_tpu_torch.kitti_eval.synthetic import write_kitti_odometry
    from supervised_dispnet_tpu_torch.utils.image_io import as_rgb, read_png

    _, H, W = MAIN_SHAPE
    t0 = time.perf_counter()
    root = write_kitti_odometry(tmp / "odometry", seed=13, frames=40)
    print(f"  synthetic odometry sequence of 40 frames in {time.perf_counter() - t0:.2f} s",
          flush=True)
    runs = {}
    for name, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        t0 = time.perf_counter()
        res = test_pose.main(["--pretrained-posenet", pose_ckpt, "--dataset-dir", str(root),
                              "--sequences", "09", "--img-height", str(H), "--img-width",
                              str(W), "--batch-size", str(POSE_BATCH), "--output-dir",
                              str(tmp / f"pose_{name}"), *extra])
        runs[name] = {"results": res, "wall_s": time.perf_counter() - t0,
                      "vectors": np.load(tmp / f"pose_{name}" / "pose_vectors.npy")}
    card_r, cpu_r = runs["card"]["results"], runs["cpu"]["results"]
    metric_rel = {k: abs(card_r[k] - cpu_r[k]) / max(abs(cpu_r[k]), 1e-30)
                  for k in ("ate_mean", "ate_std", "re_mean", "re_std")}
    vec_rel = _rel(runs["card"]["vectors"], runs["cpu"]["vectors"])
    print(f"  pose: {card_r['n_snippets']:g} snippets; ATE {card_r['ate_mean']:.6f} RE "
          f"{card_r['re_mean']:.6f}; card vs CPU metrics rel {max(metric_rel.values()):.3g}, "
          f"pose vectors rel {vec_rel:.3g} (limit 1e-3); CLI {runs['card']['wall_s']:.3f} s "
          f"on the card, {runs['cpu']['wall_s']:.3f} s on the CPU", flush=True)
    if (card_r["n_snippets"] != 38 or max(metric_rel.values()) > 1e-3 or vec_rel > 1e-3
            or not all(math.isfinite(v) for v in card_r.values())):
        raise AssertionError(f"pose: card {card_r}, CPU {cpu_r}, vectors rel {vec_rel}")

    host = {"decode_s": 0.0, "resize_s": 0.0}
    for f in sorted((root / "sequences" / "09" / "image_2").glob("*.png")):
        t0 = time.perf_counter()
        img = as_rgb(read_png(f))
        t1 = time.perf_counter()
        resize_area_uint8(img, H, W)
        host["decode_s"] += t1 - t0
        host["resize_s"] += time.perf_counter() - t1
    model = test_pose.load_pose_net(pose_ckpt, 2, "cuda")
    gen = torch.Generator().manual_seed(14)
    tgt, *refs = ((torch.rand(POSE_BATCH, H, W, 3, generator=gen) * 2 - 1).cuda()
                  for _ in range(3))

    def forward():
        with torch.inference_mode():
            return model(tgt, refs)

    ms = cuda_ms(torch, forward, reps=50, warmup=5)
    print(f"  pose host work for 40 frames: {host}; PoseExpNet forward ({POSE_BATCH}, 9, {H}, "
          f"{W}) fp32 {ms:.3f} ms a batch, {POSE_BATCH / ms * 1e3:.1f} snippets/s, on {card}",
          flush=True)
    return {"results": {n: r["results"] for n, r in runs.items()},
            "wall_s": {n: r["wall_s"] for n, r in runs.items()},
            "metric_rel_card_vs_cpu": metric_rel, "vector_rel_card_vs_cpu": vec_rel,
            "host_40_frames": host, "forward_ms": ms, "card": card}


def _serve_latency(svc, imgs, n: int = 40) -> dict:
    """Host ms of ``n`` requests, one in flight at a time: submit, then
    ``result()``."""
    lat = []
    with svc:
        for i in range(n):
            t0 = time.perf_counter()
            svc.submit(imgs[i % len(imgs)]).result(timeout=60)
            lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    return {"mean_ms": sum(lat) / n, "p50_ms": lat[n // 2], "p90_ms": lat[int(n * 0.9)],
            "max_ms": lat[-1]}


def _http(url: str, body: bytes | None = None, timeout: float = 60.0):
    """(status, body) of a GET, or a POST of ``body``; HTTP errors included."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_server_check(tmp: Path, ckpt: str, svc, frames: list) -> dict:
    """``cli/serve.py`` in a subprocess on a free localhost port, with the
    service's checkpoint and defaults: ``GET /healthz``, a ``POST /depth``
    of each PNG in ``frames`` (the ``.npy`` body against ``svc.predict`` of
    the frame area-resized as the server does, within rel 1e-4: the same
    function in another process, batched otherwise), and a body that is
    not a PNG, answered 400. The subprocess is killed at the end, whatever
    happened."""
    from supervised_dispnet_tpu_torch.data.image_resize import resize_area_uint8
    from supervised_dispnet_tpu_torch.utils.image_io import as_rgb, read_png

    _, H, W = MAIN_SHAPE
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    log = tmp / "serve.log"
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "supervised_dispnet_tpu_torch.cli.serve", "--pretrained",
             ckpt, "--network", "disp_res_50", "--img-height", str(H), "--img-width", str(W),
             "--port", str(port)], cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"serve exited with {proc.returncode}: "
                                     f"{log.read_text()[-2000:]}")
            if time.perf_counter() - t0 > 300:
                raise AssertionError(f"serve not up in 300 s: {log.read_text()[-2000:]}")
            try:
                status, body = _http(f"{url}/healthz", timeout=5)
                break
            except OSError:
                time.sleep(0.5)
        ready_s = time.perf_counter() - t0
        if (status, body) != (200, b"ok"):
            raise AssertionError(f"/healthz answered {status} {body!r}")
        worst, post_ms = 0.0, []
        for f in frames:
            t1 = time.perf_counter()
            status, body = _http(f"{url}/depth", f.read_bytes())
            post_ms.append((time.perf_counter() - t1) * 1e3)
            if status != 200:
                raise AssertionError(f"POST /depth of {f.name} answered {status}: {body[:200]!r}")
            got = np.load(io.BytesIO(body))
            want = svc.predict(resize_area_uint8(as_rgb(read_png(f)), H, W))[0]
            if got.shape != (H, W) or got.dtype != np.float32:
                raise AssertionError(f"POST /depth: {got.shape} {got.dtype}")
            worst = max(worst, _rel(got, want))
        status, body = _http(f"{url}/depth", b"\xff\xd8\xff\xe0 not a PNG")
        if status != 400 or b"only PNG" not in body:
            raise AssertionError(f"a non-PNG body answered {status}: {body[:200]!r}")
    finally:
        proc.kill()
        proc.wait(timeout=60)
    print(f"  serve: up in {ready_s:.2f} s; {len(frames)} PNG posts of 375x1242 in "
          f"{', '.join(f'{t:.1f}' for t in post_ms)} ms, depth rel {worst:.3g} against "
          f"predict (limit 1e-4); a non-PNG body answered 400", flush=True)
    if worst > 1e-4:
        raise AssertionError(f"serve: depth rel {worst} against predict")
    return {"ready_s": ready_s, "post_ms": post_ms, "depth_rel_vs_predict": worst}


def serving_phase(torch, tmp: Path, card: str, ckpt: str, tree: Path) -> dict:
    """Online serving (A5): ``DepthService.from_checkpoint`` with the BerHu
    run's DispResNet-50 checkpoint at 128x416 and the default buckets (1, 8,
    64), fused decoder (the default) and not. ``predict`` on the card
    against a ``device='cpu'`` service, within rel 1e-3, and fused against
    unfused, within rel 1e-4; 64 requests from 8 threads through
    ``submit``, all answered and within rel 1e-4 of ``predict``'s (other
    batch sizes, other cuDNN choices); latency at one request in flight;
    img/s through ``predict`` at buckets 1, 8 and 64 (host clock around the
    whole call, readback included) beside the forward alone (CUDA events);
    then the HTTP server on the tree's first 4 frames."""
    import dataclasses
    import threading

    from supervised_dispnet_tpu_torch.kitti_eval.synthetic import DATE
    from supervised_dispnet_tpu_torch.serving import DepthService, ServingConfig

    _, H, W = MAIN_SHAPE
    cfg = ServingConfig(img_height=H, img_width=W)
    rng = np.random.default_rng(15)
    svcs, warm = {}, {}
    for name, fused in (("fused", True), ("unfused", False)):
        svcs[name] = DepthService.from_checkpoint(
            ckpt, "disp_res_50", dataclasses.replace(cfg, fused_upsample=fused))
        t0 = time.perf_counter()
        svcs[name].warmup()
        warm[name] = time.perf_counter() - t0
    cpu = DepthService.from_checkpoint(ckpt, "disp_res_50", cfg, device="cpu")
    imgs = rng.integers(0, 256, (5, H, W, 3), dtype=np.uint8)
    fused, unfused, on_cpu = svcs["fused"].predict(imgs), svcs["unfused"].predict(imgs), \
        cpu.predict(imgs)
    rel_cpu, rel_fused = _rel(fused, on_cpu), _rel(fused, unfused)
    print(f"  serving: buckets {cfg.buckets} warm in {warm['fused']:.2f} s fused, "
          f"{warm['unfused']:.2f} s unfused; predict card vs CPU rel {rel_cpu:.3g} (limit "
          f"1e-3), fused vs unfused rel {rel_fused:.3g} (limit 1e-4)", flush=True)
    if fused.shape != (5, H, W) or not np.isfinite(fused).all() or rel_cpu > 1e-3 \
            or rel_fused > 1e-4:
        raise AssertionError(f"serving predict: shape {fused.shape}, card vs CPU {rel_cpu}, "
                             f"fused vs unfused {rel_fused}")

    reqs = rng.integers(0, 256, (64, H, W, 3), dtype=np.uint8)
    want = svcs["fused"].predict(reqs)
    answers, errors = {}, []

    def client(k: int) -> None:
        try:
            futs = [(i, svcs["fused"].submit(reqs[i])) for i in range(8 * k, 8 * k + 8)]
            answers.update({i: f.result(timeout=120) for i, f in futs})
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    with svcs["fused"]:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    submit_rel = max((_rel(answers[i], want[i]) for i in answers), default=math.inf)
    print(f"  serving: {len(answers)} of 64 requests from 8 threads answered; rel "
          f"{submit_rel:.3g} against predict (limit 1e-4)", flush=True)
    if errors or len(answers) != 64 or submit_rel > 1e-4:
        raise AssertionError(f"serving submit: {len(answers)} answered, errors {errors[:2]}, "
                             f"rel {submit_rel}")

    timing = {}
    for name, svc in svcs.items():
        lat = _serve_latency(svc, reqs)
        model = svc.model
        tput = {}
        for b in (1, 8, 64):
            reps = {1: 20, 8: 10, 64: 4}[b]
            svc.predict(reqs[:b])
            t0 = time.perf_counter()
            for _ in range(reps):
                svc.predict(reqs[:b])
            dt = (time.perf_counter() - t0) / reps
            x = (torch.rand(b, H, W, 3, generator=torch.Generator().manual_seed(b)) * 2
                 - 1).cuda()

            def forward():
                with torch.inference_mode():
                    return model(x)

            fwd = cuda_ms(torch, forward, reps=5 if b == 64 else 20, warmup=3)
            tput[b] = {"predict_ms": dt * 1e3, "img_per_s": b / dt, "forward_ms": fwd,
                       "forward_img_per_s": b / fwd * 1e3}
        timing[name] = {"latency_one_in_flight": lat, "throughput": tput}
        print(f"  serving {name}: one request in flight {lat['mean_ms']:.3f} ms mean, "
              f"{lat['p50_ms']:.3f} p50, {lat['p90_ms']:.3f} p90; "
              + "; ".join(f"predict B={b} {t['predict_ms']:.3f} ms ({t['img_per_s']:.1f} "
                          f"img/s), forward {t['forward_ms']:.3f} ms" for b, t in tput.items())
              + f"; on {card}", flush=True)
    frames = sorted((tree.parent / DATE / f"{DATE}_drive_0001_sync" / "image_02" / "data")
                    .glob("*.png"))[:4]
    http = http_server_check(tmp, ckpt, svcs["fused"], frames)
    return {"warmup_s": warm, "predict_rel": {"card_vs_cpu": rel_cpu,
                                              "fused_vs_unfused": rel_fused},
            "submit_rel_vs_predict": submit_rel, "timing": timing, "http": http, "card": card}


# network -> BerHu problems a step: VGG-BN's 4 disparity scales, FCRN's one
# depth map
NETWORK_PROBLEMS = {"disp_vgg_bn": 4, "fcrn": 1}


def networks_phase(torch, tmp: Path, card: str, tree: Path) -> dict:
    """The last two networks (A6a). Each trains 3 supervised BerHu steps
    through ``cli.train.main`` at 128x416, B=4, on a packed split (1 grouped
    forward and 1 grouped backward BerHu launch a step, of 4 problems for
    VGG-BN, 1 for FCRN), with its step time and profile; then its eval
    forward at (8, 3, 128, 416) from the run's checkpoint: card against CPU
    within rel 1e-3, VGG-BN fused against unfused within rel 1e-4, ms a
    batch from CUDA events and a profile of the top kernels. Last, folder
    inference of FCRN on the tree's first drive, card against CPU depths
    within rel 1e-3."""
    from supervised_dispnet_tpu_torch.cli import run_inference
    from supervised_dispnet_tpu_torch.cli import train as train_cli
    from supervised_dispnet_tpu_torch.cli.test_disp import load_model
    from supervised_dispnet_tpu_torch.kitti_eval.synthetic import DATE
    from supervised_dispnet_tpu_torch.ops.cuda import losses as kl

    B, H, W = MAIN_SHAPE
    out = {}
    for net, problems in NETWORK_PROBLEMS.items():
        write_packed(tmp / net / "data", np.random.default_rng(16), H, W)
        argv = [str(tmp / net / "data"), "--network", net, "--loss", "berhu", "-b", str(B),
                "--epoch-size", "3", "--epochs", "1", "--with-gt", "--device", "cuda",
                "--checkpoints-dir", str(tmp / net / "ckpt"), "--name", "smoke"]
        kl.berhu_fwd_launches = kl.berhu_bwd_launches = kl.berhu_fwd_problems = 0
        trainer = train_cli.main(argv)
        torch.cuda.synchronize()
        launches = {"berhu_fwd": kl.berhu_fwd_launches, "berhu_bwd": kl.berhu_bwd_launches,
                    "berhu_fwd_problems": kl.berhu_fwd_problems}
        steps = trainer.step
        want = {"berhu_fwd": steps, "berhu_bwd": steps, "berhu_fwd_problems": problems * steps}
        print(f"  {net}: {steps} steps; launches {launches}", flush=True)
        if steps < 3 or launches != want:
            raise AssertionError(f"{net}: expected launches {want} over {steps} steps, got "
                                 f"{launches}")
        losses, epoch = _read_run(trainer, steps)
        if not all(math.isfinite(epoch[k]) for k in ("abs_rel", "rmse", "a1")):
            raise AssertionError(f"{net}: validation metrics not finite: {epoch}")
        timed = steady_step(torch, trainer, f"{net} BerHu", card)
        berhu = {r["kernel"]: r["calls_per_step"] for r in timed["profile"]["own_kernels"]
                 if "berhu_" in r["kernel"]}
        if sorted(round(v) for v in berhu.values()) != [1, 1]:
            raise AssertionError(f"{net}: the step's profile shows BerHu kernels {berhu}")
        ckpt = str(Path(trainer.cfg.save_path) / "dispnet_checkpoint.pth.tar")

        x = torch.rand(EVAL_BATCH, H, W, 3, generator=torch.Generator().manual_seed(17)) * 2 - 1
        preds, fwd = {}, {}
        variants = [("card", False, "cuda"), ("cpu", False, "cpu")]
        if net == "disp_vgg_bn":
            variants.append(("card_fused", True, "cuda"))
        for name, fused_up, dev in variants:
            model = load_model(ckpt, net, fused_upsample=fused_up, device=dev)
            xd = x.to(next(model.parameters()).device)

            def forward():
                with torch.inference_mode():
                    o = model(xd)
                    return o[0] if isinstance(o, list) else o

            preds[name] = forward().cpu().numpy()
            if dev == "cuda":
                ms = cuda_ms(torch, forward, reps=20, warmup=3)
                fwd[name] = {"ms": ms, "img_per_s": EVAL_BATCH / ms * 1e3,
                             "profile": profile_steps(torch, forward, n=5, top=8)}
                print(f"  {net} eval forward {name}: ({EVAL_BATCH}, 3, {H}, {W}) fp32 "
                      f"{ms:.3f} ms, {EVAL_BATCH / ms * 1e3:.1f} img/s, on {card}", flush=True)
        rel_cpu = _rel(preds["card"], preds["cpu"])
        rel_fused = _rel(preds["card_fused"], preds["card"]) if "card_fused" in preds else None
        print(f"  {net} eval forward: card vs CPU rel {rel_cpu:.3g} (limit 1e-3)"
              + (f", fused vs unfused rel {rel_fused:.3g} (limit 1e-4)" if rel_fused is not None
                 else ""), flush=True)
        if rel_cpu > 1e-3 or (rel_fused is not None and rel_fused > 1e-4):
            raise AssertionError(f"{net}: eval forward card vs CPU {rel_cpu}, fused {rel_fused}")
        out[net] = {"launches": launches, "train_losses": losses,
                    "val": {k: epoch[k] for k in ("abs_rel", "rmse", "a1")},
                    "step_ms": timed["step_ms"], "step_ms_tf32": timed["step_ms_tf32"],
                    "profile": timed["profile"], "eval_forward": fwd,
                    "eval_rel": {"card_vs_cpu": rel_cpu, "fused_vs_unfused": rel_fused},
                    "checkpoint": ckpt}

    frames = tree.parent / DATE / f"{DATE}_drive_0001_sync" / "image_02" / "data"
    for name, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        run_inference.main(["--pretrained", out["fcrn"]["checkpoint"], "--network", "fcrn",
                            "--dataset-dir", str(frames), "--output-dir",
                            str(tmp / f"fcrn_infer_{name}"), "--img-height", str(H),
                            "--img-width", str(W), "--save-npy", *extra])
    stems = sorted(f.stem for f in frames.glob("*.png"))
    worst = max(_rel(*(np.load(tmp / f"fcrn_infer_{n}" / f"{s}_depth.npy")
                       for n in ("card", "cpu"))) for s in stems)
    print(f"  fcrn inference: {len(stems)} frames, depth card vs CPU rel {worst:.3g} "
          f"(limit 1e-3)", flush=True)
    if len(stems) != 8 or worst > 1e-3:
        raise AssertionError(f"fcrn inference: {len(stems)} frames, rel {worst}")
    out["fcrn_inference_rel_card_vs_cpu"] = worst
    return out


# the trainer's options (slice 6): the flags of the run through the CLI
OPTION_FLAGS = ("--bf16", "--ema-decay", "0.999", "--accum-steps", "2", "--hue", "0.1",
                "--imagenet-normalization")
OPTION_UPDATES = 4  # an epoch of 4 updates of 2 micro-batches
# (label, network, loss, the kernel counters of one step's launches each way)
BF16_STEPS = (
    ("DispResNet-50 BerHu", "disp_res_50", "berhu", ("berhu_fwd_launches",
                                                     "berhu_bwd_launches")),
    ("DispResNet-50 classification", "disp_res_50", "classification",
     ("ce_fwd_launches", "ce_bwd_launches")),
    ("DispNetS + PoseExpNet selfsup", "dispnet", "selfsup",
     ("warp_fwd_launches", "warp_bwd_coords_launches")),
    ("VGG-BN BerHu", "disp_vgg_bn", "berhu", ("berhu_fwd_launches", "berhu_bwd_launches")),
)
REMAT_BATCHES = (4, 32)


def write_resnet_pth(torch, path: Path, depth: int = 50, seed: int = 5) -> dict:
    """A torchvision-layout ResNet state dict from ``seed``, as a user's
    ImageNet ``.pth`` is laid out: random weights, BN statistics away from
    0 / 1, a 1000-way ``fc``."""
    from supervised_dispnet_tpu_torch.models.resnet import ResNetEncoder

    g = torch.Generator().manual_seed(seed)
    enc = ResNetEncoder(depth)
    enc.init_weights(g)
    with torch.no_grad():
        for name, b in enc.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0.0, 0.1, generator=g)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=g)
    sd = {**enc.state_dict(),
          "fc.weight": 0.01 * torch.randn(1000, enc.feature_channels[-1], generator=g),
          "fc.bias": torch.zeros(1000)}
    torch.save(sd, path)
    return sd


@contextlib.contextmanager
def kernel_input_dtypes(torch):
    """{entry: the dtypes of the floating tensors handed to it} for the
    training steps' kernel entries (the grouped BerHu, the CE, the grouped
    warp), while the block runs; each entry is called through."""
    from supervised_dispnet_tpu_torch.ops.cuda import classification as kc
    from supervised_dispnet_tpu_torch.ops.cuda import losses as kl
    from supervised_dispnet_tpu_torch.ops.cuda import warp as kw

    seen: dict[str, set] = {}
    entries = [(kl, "berhu_forward_many"), (kl, "berhu_backward_many"), (kc, "ce_forward"),
               (kc, "ce_backward"), (kw, "warp_forward_many"),
               (kw, "warp_backward_coords_many")]

    def record(name, fn):
        def wrapper(*args, **kwargs):
            flat = [t for a in (*args, *kwargs.values())
                    for t in (a if isinstance(a, (list, tuple)) else [a])]
            seen.setdefault(name, set()).update(
                str(t.dtype) for t in flat
                if isinstance(t, torch.Tensor) and t.is_floating_point())
            return fn(*args, **kwargs)
        return wrapper

    saved = [(m, n, getattr(m, n)) for m, n in entries]
    for m, n, fn in saved:
        setattr(m, n, record(n, fn))
    try:
        yield seen
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def _options_run(torch, argv: list, epochs: int, *extra: str):
    """``cli.train.main`` with the BerHu counters zeroed just before it;
    returns (trainer, launches, printed text)."""
    from supervised_dispnet_tpu_torch.cli import train as train_cli
    from supervised_dispnet_tpu_torch.ops.cuda import losses as kl

    tee = _Tee(sys.stdout)
    kl.berhu_fwd_launches = kl.berhu_bwd_launches = kl.berhu_fwd_problems = 0
    with contextlib.redirect_stdout(tee):
        trainer = train_cli.main([*argv, "--epochs", str(epochs), *extra])
    torch.cuda.synchronize()
    return trainer, {"berhu_fwd": kl.berhu_fwd_launches, "berhu_bwd": kl.berhu_bwd_launches,
                     "berhu_fwd_problems": kl.berhu_fwd_problems}, tee.buf.getvalue()


def options_run_phase(torch, tmp: Path, device: str = "cuda") -> dict:
    """DispResNet-50 BerHu through ``cli.train.main`` at 128x416, B=4, with
    the trainer's options on (``OPTION_FLAGS`` and ``--pretrained-encoder``
    of a torchvision-layout ResNet-50 written here): one epoch of 4 updates
    of 2 micro-batches, then ``--resume`` for a second. BerHu launches 1 + 1
    a micro-step (2 + 2 an update), of 4 problems, and every kernel entry
    is handed float32 under ``--bf16``; the second run continues the first's
    run directory, step, EMA shadow and generator (its checkpoint, copied
    before the resume, restores to the first run's end state)."""
    from supervised_dispnet_tpu_torch.cli import train as train_cli
    from supervised_dispnet_tpu_torch.models import get_disp_net
    from supervised_dispnet_tpu_torch.training.trainer import Trainer

    B, H, W = MAIN_SHAPE
    k = 2
    write_packed(tmp / "data", np.random.default_rng(20), H, W, n_train=OPTION_UPDATES * k * B)
    enc = write_resnet_pth(torch, tmp / "resnet50.pth")
    model = get_disp_net("disp_res_50", device="cpu")
    train_cli.load_pretrained_encoder(model, tmp / "resnet50.pth", "disp_res_50")
    if not all(torch.equal(v, enc[n]) for n, v in model.encoder.state_dict().items()):
        raise AssertionError("--pretrained-encoder: the encoder does not hold the file")
    argv = [str(tmp / "data"), "--network", "disp_res_50", "--loss", "berhu", "-b", str(B),
            "--epoch-size", str(OPTION_UPDATES * k), "--with-gt", *OPTION_FLAGS,
            "--pretrained-encoder", str(tmp / "resnet50.pth"), "--device", device,
            "--checkpoints-dir", str(tmp / "ckpt"), "--name", "options"]
    t0 = time.perf_counter()
    with kernel_input_dtypes(torch) as dtypes:
        first, launches, _ = _options_run(torch, argv, 1)
    first_s = time.perf_counter() - t0
    micro = first.update.micro_step
    want = {"berhu_fwd": micro, "berhu_bwd": micro, "berhu_fwd_problems": 4 * micro}
    print(f"  options run: {first.step} updates of {k} micro-steps, launches {launches}, "
          f"kernel inputs {dict((n, sorted(d)) for n, d in dtypes.items())}, "
          f"{first_s:.1f} s", flush=True)
    if first.step != OPTION_UPDATES or micro != k * OPTION_UPDATES or launches != want:
        raise AssertionError(f"options run: {first.step} updates, {micro} micro-steps, "
                             f"launches {launches} (want {want})")
    if set(dtypes) != {"berhu_forward_many", "berhu_backward_many"} or any(
            d != {"torch.float32"} for d in dtypes.values()):
        raise AssertionError(f"under --bf16 the BerHu kernels were handed {dtypes}")
    run = Path(first.cfg.save_path)
    end0 = {"ema": [e.cpu().clone() for e in first.update.ema],
            "generator": first.generator.get_state(), "micro_step": micro}
    shutil.copytree(run, tmp / "epoch0")

    second, launches2, text = _options_run(torch, argv, 2, "--resume")
    micro2 = second.update.micro_step
    print(f"  options resume: {second.cfg.save_path}, {second.step} updates, launches "
          f"{launches2}", flush=True)
    if (Path(second.cfg.save_path) != run or micro2 != 2 * micro or launches2 != want
            or f"resumed after epoch 0 (train step {micro}" not in text):
        raise AssertionError(f"--resume: run {second.cfg.save_path} (first {run}), "
                             f"{micro2} micro-steps, launches {launches2}")
    events = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    steps = [e["step"] for e in events if e["event"] == "train_iter"]
    epochs = [e for e in events if e["event"] == "epoch"]
    losses = [e["loss"] for e in events if e["event"] == "train_iter"]
    if (steps != list(range(1, 2 * micro + 1)) or [e["epoch"] for e in epochs] != [0, 1]
            or not all(math.isfinite(v) for v in losses)
            or not all(math.isfinite(e["abs_rel"]) for e in epochs)):
        raise AssertionError(f"--resume: steps {steps}, epochs {epochs}")
    restored = Trainer(second.cfg, get_disp_net("disp_res_50", device=device), device=device)
    if restored.restore(tmp / "epoch0")["epoch"] != 0:
        raise AssertionError("the epoch-0 checkpoint is not epoch 0's")
    if (restored.update.micro_step != end0["micro_step"]
            or not torch.equal(restored.generator.get_state(), end0["generator"])
            or not all(torch.equal(a.cpu(), b)
                       for a, b in zip(restored.update.ema, end0["ema"]))):
        raise AssertionError("the epoch-0 checkpoint does not hold the first run's step, "
                             "EMA shadow and generator")
    return {"launches_per_update": {n: v / first.step for n, v in launches.items()},
            "kernel_input_dtypes": {n: sorted(d) for n, d in dtypes.items()},
            "first_run_s": first_s, "train_losses": losses,
            "val_abs_rel": [e["abs_rel"] for e in epochs]}


def bf16_steps_phase(torch, tmp: Path, card: str) -> dict:
    """The four training steps (``BF16_STEPS``) at 128x416, B=4, in fp32 and
    with ``--bf16``, side by side on one batch: img/s from CUDA events over
    20 steps (``utils/profiling.py::steady_state_images_per_sec``), each
    kernel's launches a step (the same in both), the heads' outputs float32
    under bf16, and a profile (busy ms; the bf16 step's kernels in bf16)."""
    from supervised_dispnet_tpu_torch.models import PoseExpNet, get_disp_net
    from supervised_dispnet_tpu_torch.training.trainer import Trainer, TrainerConfig
    from supervised_dispnet_tpu_torch.utils.profiling import steady_state_images_per_sec

    B, H, W = MAIN_SHAPE
    write_packed(tmp / "data", np.random.default_rng(21), H, W)
    out = {}
    for label, net, loss, counted in BF16_STEPS:
        row = {}
        for bf16 in (False, True):
            head = "classification" if loss == "classification" else "disp"
            model = get_disp_net(net, head=head, seed=3)
            pose = (PoseExpNet(generator=torch.Generator().manual_seed(4))
                    if loss == "selfsup" else None)
            trainer = Trainer(TrainerConfig(data=str(tmp / "data"), loss=loss, batch_size=B,
                                            bf16=bf16, save_path=str(tmp / "run")),
                              model, pose)
            loader = iter(trainer.make_loaders()[0])
            batch = trainer.prep_train_batch(next(loader))
            loader.close()
            heads = set()
            hook = trainer.model.register_forward_hook(lambda m, i, o: heads.update(
                str(t.dtype) for t in (o if isinstance(o, list) else [o])))
            for mod, attr in kernel_counters():
                setattr(mod, attr, 0)
            ips = steady_state_images_per_sec(lambda: trainer.train_step(batch), B,
                                              trainer.device, iters=20, warmup=3)
            hook.remove()
            per_step = {a: getattr(m, a) / 23 for m, a in kernel_counters() if a in counted}
            prof = profile_steps(torch, lambda: trainer.train_step(batch), n=5, top=6,
                                 count=("bf16", "BFloat16"))
            tag = "bf16" if bf16 else "fp32"
            print(f"  {label} {tag}: {B / ips * 1e3:.3f} ms a step, {ips:.1f} img/s, busy "
                  f"{prof['busy_ms_per_step']:.3f} ms; launches a step {per_step}; heads "
                  f"{sorted(heads)}; bf16 kernels a step {prof['counts']}, on {card}",
                  flush=True)
            if set(per_step.values()) != {1.0} or heads != {"torch.float32"}:
                raise AssertionError(f"{label} {tag}: launches a step {per_step}, heads "
                                     f"{heads}")
            if (sum(prof["counts"].values()) > 0) != bf16:
                raise AssertionError(f"{label} {tag}: bf16 kernels {prof['counts']}")
            row[tag] = {"step_ms": B / ips * 1e3, "img_per_s": ips,
                        "busy_ms": prof["busy_ms_per_step"], "launches": per_step,
                        "profile": prof}
            del trainer, model, pose, batch
            torch.cuda.empty_cache()
        out[label] = row
    return out


def bf16_cross_check(torch) -> dict:
    """One DispResNet-50 BerHu step with a bf16 trunk from identical weights
    on one batch, augmentation off: the card (kernels) against the CPU
    (plain versions). The loss within rel 1e-2 and the decoder's and heads'
    gradients within 0.1 by relative L2 (all of them as one vector): two
    bf16 implementations round a value near a tie differently. The
    encoder's gradients are not fixed by the inputs in bf16: a randomly
    initialised ResNet-50's train-mode BNs amplify a 1e-6 change of one
    weight into ~2% of them, bf16's ~4e-3 roundings into ~100% (the CPU's
    own bf16 step against its fp32 step, measured here beside them). They
    are held to be finite and to keep their norm within 2x."""
    from supervised_dispnet_tpu_torch.models import DispResNet
    from supervised_dispnet_tpu_torch.models.common import set_compute_dtype

    B, H, W = MAIN_SHAPE
    rng = np.random.default_rng(22)
    depth = rng.uniform(1.0, 80.0, (B, H, W)) * (rng.uniform(size=(B, H, W)) < 0.1)
    batch = {"tgt": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
             "intrinsics": np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)),
             "depth": depth.astype(np.float16)}
    base = DispResNet(50, generator=torch.Generator().manual_seed(3))
    l_32, g_32 = _one_step(torch, copy.deepcopy(base), batch, "cpu", plain=True)
    set_compute_dtype(base, torch.bfloat16)
    t0 = time.perf_counter()
    l_card, g_card = _one_step(torch, copy.deepcopy(base).to("cuda"), batch, "cuda")
    l_cpu, g_cpu = _one_step(torch, copy.deepcopy(base), batch, "cpu", plain=True)
    cpu_s = time.perf_counter() - t0

    def rel(a, b, names):
        return _rel_l2(torch.cat([a[n].flatten() for n in names]),
                       torch.cat([b[n].flatten() for n in names]))

    enc = [n for n in g_cpu if n.startswith("encoder.")]
    dec = [n for n in g_cpu if not n.startswith("encoder.")]
    loss_rel = abs(l_card / l_cpu - 1)
    out = {"loss": [l_card, l_cpu], "loss_rel": loss_rel,
           "decoder_heads_rel_l2": rel(g_card, g_cpu, dec),
           "encoder_rel_l2": rel(g_card, g_cpu, enc),
           "encoder_norm_ratio": float(torch.cat([g_card[n].flatten() for n in enc]).norm()
                                       / torch.cat([g_cpu[n].flatten() for n in enc]).norm()),
           "cpu_bf16_vs_fp32": {"loss_rel": abs(l_cpu / l_32 - 1),
                                "decoder_heads_rel_l2": rel(g_cpu, g_32, dec),
                                "encoder_rel_l2": rel(g_cpu, g_32, enc)}}
    finite = all(bool(torch.isfinite(g_card[n]).all()) for n in g_card)
    print(f"  bf16 cross-check DispResNet-50 card vs CPU: loss {l_card:.7g} / {l_cpu:.7g} "
          f"(rel {loss_rel:.3g}, limit 1e-2); decoder and heads' gradients rel-L2 "
          f"{out['decoder_heads_rel_l2']:.3g} (limit 0.1); encoder's rel-L2 "
          f"{out['encoder_rel_l2']:.3g}, norm ratio {out['encoder_norm_ratio']:.3g} (limit "
          f"0.5..2); the CPU's bf16 step vs its fp32 step: {out['cpu_bf16_vs_fp32']}; "
          f"{cpu_s:.1f} s", flush=True)
    if (loss_rel > 1e-2 or out["decoder_heads_rel_l2"] > 0.1 or not finite
            or not 0.5 <= out["encoder_norm_ratio"] <= 2.0):
        raise AssertionError(f"bf16 cross-check: {out}")
    return out


def remat_phase(torch, card: str) -> dict:
    """One DispResNet-50 BerHu step (fp32, augmentation off) without remat
    (twice), with ``"full"`` and with ``"conv"``, from identical weights, at
    B=4 and B=32: peak ``max_memory_allocated`` of the step and its ms (CUDA
    events over 5 steps); the loss within 1e-6, each BN running statistic
    within 1e-6 (updated once, not again by the recompute) and each gradient
    within 1e-5 rel-L2 of the step without remat, or within 4x what the
    second step without remat differs by (the backward's atomics, upsample
    and cuDNN, sum in another order each run); full remat's peak below
    none's at B=32."""
    from supervised_dispnet_tpu_torch.data.augment import AugmentConfig
    from supervised_dispnet_tpu_torch.models import DispResNet
    from supervised_dispnet_tpu_torch.models.common import set_remat
    from supervised_dispnet_tpu_torch.training.train_step import make_supervised_train_step

    _, H, W = MAIN_SHAPE
    no_aug = AugmentConfig(flip=False, scale_crop=False, color_jitter=False)
    base = DispResNet(50, generator=torch.Generator().manual_seed(3))
    out = {}
    for B in REMAT_BATCHES:
        rng = np.random.default_rng(23)
        depth = rng.uniform(1.0, 80.0, (B, H, W)) * (rng.uniform(size=(B, H, W)) < 0.1)
        batch = {"tgt": torch.from_numpy(rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)),
                 "intrinsics": torch.eye(3).expand(B, 3, 3).contiguous(),
                 "depth": torch.from_numpy(depth.astype(np.float16))}
        batch = {k: v.cuda() for k, v in batch.items()}
        ref, rows, noise = None, {}, 0.0
        for remat in ("none", "none again", "full", "conv"):
            model = copy.deepcopy(base).cuda()
            set_remat(model, None if remat.startswith("none") else remat)
            opt = torch.optim.Adam(model.parameters(), lr=1e-4)
            step = make_supervised_train_step(model, opt, "berhu", aug=no_aug)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            loss = float(step(batch)["loss"])
            peak = torch.cuda.max_memory_allocated() - before
            grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
            stats = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
            g_rel = s_rel = 0.0
            if ref is None:
                ref = (loss, grads, stats)
            else:
                g_rel = max(_rel_l2(grads[n], g) for n, g in ref[1].items())
                s_rel = max(_rel_l2(stats[n], s) for n, s in ref[2].items())
                noise = g_rel if remat == "none again" else noise
                if (abs(loss / ref[0] - 1) > 1e-6 or s_rel > 1e-6
                        or g_rel > max(1e-5, 4 * noise)):
                    raise AssertionError(f"remat {remat} B={B}: loss {loss} vs {ref[0]}, "
                                         f"gradients {g_rel} (none against none {noise}), "
                                         f"BN statistics {s_rel}")
            ms = cuda_ms(torch, lambda: step(batch), reps=5, warmup=1)
            rows[remat] = {"peak_bytes": peak, "step_ms": ms, "loss": loss,
                           "grad_rel_l2_max": g_rel, "bn_stats_rel_max": s_rel}
            print(f"  remat {remat:10s} B={B}: peak {peak / 2**30:.3f} GiB above the model, "
                  f"step {ms:.3f} ms, loss {loss:.7g}, gradients rel-L2 max {g_rel:.3g}, "
                  f"BN statistics {s_rel:.3g}, on {card}", flush=True)
            del model, opt, step, grads
            torch.cuda.empty_cache()
        if B == max(REMAT_BATCHES) and rows["full"]["peak_bytes"] >= rows["none"]["peak_bytes"]:
            raise AssertionError(f"remat full does not lower the peak at B={B}: {rows}")
        out[f"B{B}"] = rows
    return out


def debug_profile_phase(torch, tmp: Path) -> dict:
    """``--debug-nans``: a step on a batch with one NaN pixel raises
    ``FloatingPointError`` naming the step, and leaves the weights as they
    were; ``--profile-steps 2`` through the CLI leaves a trace with the
    card's kernels in it."""
    from supervised_dispnet_tpu_torch.models import get_disp_net
    from supervised_dispnet_tpu_torch.training.trainer import Trainer, TrainerConfig

    B, H, W = MAIN_SHAPE
    write_packed(tmp / "data", np.random.default_rng(24), H, W)
    trainer = Trainer(TrainerConfig(data=str(tmp / "data"), batch_size=B, debug_nans=True,
                                    save_path=str(tmp / "run")),
                      get_disp_net("disp_res_50", seed=3))
    loader = iter(trainer.make_loaders()[0])
    batch = trainer.prep_train_batch(next(loader))
    loader.close()
    trainer.train_step(batch)
    bad = dict(batch, tgt=batch["tgt"].float() / 255.0)
    bad["tgt"][1, 5, 7, 0] = float("nan")
    before = [p.detach().clone() for p in trainer.model.parameters()]
    try:
        trainer.train_step(bad)
        raise AssertionError("--debug-nans: a NaN batch did not raise")
    except FloatingPointError as e:
        message = str(e)
    if "train step 1" not in message or not all(
            torch.equal(p, q) for p, q in zip(trainer.model.parameters(), before)):
        raise AssertionError(f"--debug-nans: {message!r}, or the weights moved")
    print(f"  --debug-nans: raised {message!r}", flush=True)
    del trainer
    from supervised_dispnet_tpu_torch.cli import train as train_cli

    t = train_cli.main([str(tmp / "data"), "--network", "disp_res_50", "--loss", "berhu",
                        "-b", str(B), "--epoch-size", "3", "--epochs", "1", "--with-gt",
                        "--profile-steps", "2", "--checkpoints-dir", str(tmp / "ckpt"),
                        "--name", "profile"])
    trace = Path(t.cfg.save_path) / "profile" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    print(f"  --profile-steps 2: {trace} ({trace.stat().st_size} bytes, {kernels} kernel "
          f"events)", flush=True)
    if kernels == 0:
        raise AssertionError("--profile-steps: the trace holds no kernel of the card")
    return {"debug_nans_message": message, "trace_bytes": trace.stat().st_size,
            "trace_kernel_events": kernels}


CAST_VARIANTS = ("fp32", "bf16, a cast a conv, BN in fp32", "bf16, a cast a conv",
                 "bf16, one cast a forward")


def _cast_variant(torch, variant: str):
    """Install ``variant``'s casting on the port's classes; returns the
    undo. "a cast a conv" is the committed design; "BN in fp32" also casts
    each BN's input to float32 and its output back; "one cast a forward"
    casts all trunk weights at the start of the model's forward in one
    multi-tensor copy, and their gradients back in one, from hooks that
    ``_cast_once_a_forward`` adds."""
    import torch.nn.functional as F

    from supervised_dispnet_tpu_torch.models import common

    bn_forward = common.BatchNorm2d.forward
    compute_params = common._ComputeParams.compute_params

    def bn_in_fp32(self, x):
        x = x.to(torch.float32)
        if not self.training:
            y = torch.nn.BatchNorm2d.forward(self, x)
        else:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked += 1
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y if self.compute_dtype is None else y.to(self.compute_dtype)

    def cached(self):
        cast = getattr(self, "_cast", None)
        if cast is not None and cast[2] == self.weight._version:
            return cast[0], cast[1]
        return compute_params(self)

    if variant == CAST_VARIANTS[1]:
        common.BatchNorm2d.forward = bn_in_fp32
    if variant == CAST_VARIANTS[3]:
        common._ComputeParams.compute_params = cached

    def undo():
        common.BatchNorm2d.forward = bn_forward
        common._ComputeParams.compute_params = compute_params
    return undo


def _cast_once_a_forward(torch, model) -> None:
    from supervised_dispnet_tpu_torch.models import common

    class CastParams(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *params):
            out = [torch.empty_like(p, dtype=torch.bfloat16) for p in params]
            torch._foreach_copy_(out, list(params))
            return tuple(out)

        @staticmethod
        def backward(ctx, *grads):
            out = [torch.empty_like(g, dtype=torch.float32) for g in grads]
            torch._foreach_copy_(out, list(grads))
            return tuple(out)

    convs = [m for m in model.modules()
             if isinstance(m, (common.Conv2d, common.ConvTranspose2d))]

    def cast(module, args):
        params = [t for m in convs for t in (m.weight, m.bias) if t is not None]
        out = iter(CastParams.apply(*params))
        for m in convs:
            m._cast = (next(out), None if m.bias is None else next(out), m.weight._version)

    def drop(module, args, output):
        for m in convs:
            m._cast = None

    model.register_forward_pre_hook(cast)
    model.register_forward_hook(drop)


def cast_variants_phase(torch, tmp: Path, card: str) -> dict:
    """What the explicit casts of ``--bf16`` cost DispResNet-50's BerHu step
    at 128x416, B=4: ``CAST_VARIANTS`` in turns, twice (CUDA events over 20
    steps after 3; busy ms and kernel launches a step from the profile)."""
    from supervised_dispnet_tpu_torch.models import get_disp_net
    from supervised_dispnet_tpu_torch.training.trainer import Trainer, TrainerConfig
    from supervised_dispnet_tpu_torch.utils.profiling import steady_state_images_per_sec

    B, H, W = MAIN_SHAPE
    write_packed(tmp / "data", np.random.default_rng(25), H, W)
    rows = []
    for turn in range(2):
        for variant in (CAST_VARIANTS if turn == 0 else CAST_VARIANTS[::-1]):
            undo = _cast_variant(torch, variant)
            try:
                model = get_disp_net("disp_res_50", seed=3)
                trainer = Trainer(TrainerConfig(data=str(tmp / "data"), batch_size=B,
                                                bf16=variant != "fp32",
                                                save_path=str(tmp / "run")), model)
                if variant == CAST_VARIANTS[3]:
                    _cast_once_a_forward(torch, model)
                loader = iter(trainer.make_loaders()[0])
                batch = trainer.prep_train_batch(next(loader))
                loader.close()
                ips = steady_state_images_per_sec(lambda: trainer.train_step(batch), B,
                                                  trainer.device, iters=20, warmup=3)
                prof = profile_steps(torch, lambda: trainer.train_step(batch), n=5, top=0)
            finally:
                undo()
            launches = prof["launches_per_step"]
            rows.append({"variant": variant, "turn": turn, "step_ms": B / ips * 1e3,
                         "busy_ms": prof["busy_ms_per_step"], "launches": launches})
            print(f"  casts: {variant:32s} turn {turn}: step {B / ips * 1e3:.3f} ms, busy "
                  f"{prof['busy_ms_per_step']:.3f} ms, {launches:.0f} kernels a step, on "
                  f"{card}", flush=True)
            del trainer, model, batch
            torch.cuda.empty_cache()
    return {"rows": rows}


def options_phase(torch, tmp: Path, card: str) -> dict:
    """Slice 6, the trainer's options on the card: the run through the CLI
    with them on and its resume, fp32 against bf16 steps, the card's bf16
    step against the CPU's, remat's memory and time, the NaN check and the
    step trace."""
    t0 = time.perf_counter()
    out = {"run": options_run_phase(torch, tmp / "run"),
           "bf16_steps": bf16_steps_phase(torch, tmp / "bf16", card),
           "bf16_cross_check": bf16_cross_check(torch),
           "remat": remat_phase(torch, card),
           "debug_profile": debug_profile_phase(torch, tmp / "debug"),
           "casts": cast_variants_phase(torch, tmp / "casts", card)}
    out["seconds"] = time.perf_counter() - t0
    print(f"  options phase: {out['seconds']:.1f} s", flush=True)
    return out


# -- slice 7: the photometric loss's arms, the training-output images, the
# loaders and a short convergence check ------------------------------------

# arm: (the CLI's flags, or None where the JAX CLI has none and the step
# builder takes it; the step builder's options; problems a grouped launch)
PHOTO_ARMS = {
    "default": ([], {}, 8),
    "half_res": (["--half-res-photo"], {"half_res_photo": True}, 8),
    "stochastic_2": (["--stochastic-photo", "2"], {"stochastic_photo": 2}, 8),
    "batch_refs": (None, {"batch_refs": True}, 4),
}
ARM_PHASES = ((0, 1), (1, 0), (1, 1), (0, 0))  # the stochastic arm's, card vs CPU
WARP_COUNTERS = {"warp_fwd": "warp_fwd_launches", "warp_bwd": "warp_bwd_launches",
                 "warp_bwd_coords": "warp_bwd_coords_launches",
                 "warp_fwd_problems": "warp_fwd_problems",
                 "warp_bwd_coords_problems": "warp_bwd_coords_problems"}


def _warp_counts(kw, zero: bool = False) -> dict:
    """The warp kernels' launch and problem counters; ``zero`` sets them to
    0 after reading them."""
    counts = {k: getattr(kw, a) for k, a in WARP_COUNTERS.items()}
    if zero:
        for a in WARP_COUNTERS.values():
            setattr(kw, a, 0)
    return counts


def _selfsup_argv(data: Path, ckpt: Path, name: str, steps: int, *extra: str) -> list:
    """``cli.train`` arguments of BASELINE config 5 at the main path's batch."""
    return [str(data), "--network", "dispnet", "--loss", "selfsup", "--sequence-length", "3",
            "-p", "1.0", "-m", "0.2", "-s", "0.1", "-b", str(MAIN_SHAPE[0]),
            "--epoch-size", str(steps), "--epochs", "1", "--checkpoints-dir", str(ckpt),
            "--name", name, *extra]


class RecordingWriter:
    """A tensorboard writer that keeps the images it is handed."""

    def __init__(self):
        self.images = {}

    def add_image(self, tag, img, step):
        self.images[tag] = np.asarray(img, np.float32)

    def add_scalar(self, *args, **kwargs):
        pass

    def close(self):
        pass


def _first_batch(trainer):
    """The first batch of the trainer's train loader, on the card."""
    loader = iter(trainer.make_loaders()[0])
    batch = trainer.prep_train_batch(next(loader))
    loader.close()  # stops the loader's prefetch thread
    return batch


def _arm_problems(torch, step, seed: int) -> list:
    """The sampling problems that one call of ``step()`` hands
    ``ops.warp.sample_many``, each with a seeded upstream gradient: (img, x,
    y, g), as ``_group_agrees`` takes them."""
    from supervised_dispnet_tpu_torch.ops import warp as wp

    seen, real = [], wp.sample_many

    def spy(imgs, xs, ys, padding_mode="zeros"):
        seen.append([(i.detach().to(torch.float32).contiguous(), x.detach().contiguous(),
                      y.detach().contiguous()) for i, x, y in zip(imgs, xs, ys)])
        return real(imgs, xs, ys, padding_mode)

    wp.sample_many = spy
    try:
        step()
    finally:
        wp.sample_many = real
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [(i, x, y, torch.randn(*x.shape, i.shape[-1], device="cuda", generator=gen))
            for i, x, y in seen[0]]


def arm_cross_check(torch, arm: str) -> dict:
    """One self-supervised step of a photometric arm from identical weights
    on one batch, augmentation off, TF32 off: the card (kernels) against
    the CPU (plain sampler), at the default step's tolerance
    (``selfsup_cross_check``: loss and terms rtol 1e-4, each gradient tensor
    within 1e-3 relative L2); the stochastic arm with fixed phases."""
    opts = PHOTO_ARMS[arm][1]
    phases = ARM_PHASES if "stochastic_photo" in opts else None
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        batch, base = _selfsup_check_inputs(torch)
        l_a, g_a = _one_selfsup_step(torch, *(copy.deepcopy(m).cuda() for m in base), batch,
                                     "cuda", photo_phases=phases, **opts)
        l_b, g_b = _one_selfsup_step(torch, *(copy.deepcopy(m) for m in base), batch, "cpu",
                                     plain=True, photo_phases=phases, **opts)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    rels = {n: _rel_l2(g_a[n], g_b[n]) for n in g_b}
    worst = max(rels, key=rels.get)
    loss_rel = max(abs(l_a[k] - l_b[k]) / max(abs(l_b[k]), 1e-30) for k in l_b)
    print(f"  cross-check {arm} arm card vs cpu: loss {l_a['loss']:.7g} / {l_b['loss']:.7g} "
          f"(photo {l_a['photo_loss']:.7g} / {l_b['photo_loss']:.7g}, worst term rel "
          f"{loss_rel:.3g}); {len(rels)} gradients rel-L2 max {rels[worst]:.3g} ({worst})",
          flush=True)
    if loss_rel > 1e-4 or rels[worst] > 1e-3:
        raise AssertionError(f"cross-check {arm} arm: loss rel {loss_rel:.3g} (limit 1e-4), "
                             f"gradient {worst} rel-L2 {rels[worst]:.3g} (limit 1e-3)")
    return {"loss": [l_a["loss"], l_b["loss"]], "loss_rel": loss_rel,
            "rel_l2_max": rels[worst], "rel_l2_worst": worst}


def _warped_image_agrees(torch, card_img, cpu_img, seen: dict, padding_mode: str) -> dict:
    """Holds the card's training-output warped image (C, H, W) against the
    CPU port's on the same weights and input. The image is the bilinear
    sampler at coordinates that each device's geometry rounds its own way
    (cuBLAS and the CPU sum the 3x3 products in different orders; one
    float32 ulp of a coordinate near 400 px is 3.05e-5 px), and the frames
    are uniform noise, whose neighbours differ by up to 1, so a fixed
    absolute limit on the images would measure rounding. ``seen`` holds each
    device's (img, x, y) as handed to ``ops.warp.sample``. Three checks:
    the card's image against the plain sampler at the card's own
    coordinates (rtol 1e-5, atol 1e-6, as ``_group_agrees``); the card's
    coordinates against the CPU's (1e-3 px); and the two images per pixel
    within what that coordinate difference allows: bilinear sampling of the
    zero-padded frame is Lipschitz in x and y with the frame's largest
    horizontal and vertical neighbour differences, and the clip to [0, 1]
    keeps the bound, so |card - CPU| <= Lx |dx| + Ly |dy| + 1e-6."""
    from supervised_dispnet_tpu_torch.ops.sampling import bilinear_sample

    (img, x, y), (_, x_p, y_p) = seen["cuda"], seen["cpu"]
    plain = bilinear_sample(img.to(torch.float32), x, y, padding_mode)[0]
    plain = np.clip(plain.numpy(), 0, 1).transpose(2, 0, 1)
    kernel_ok = np.allclose(card_img, plain, rtol=1e-5, atol=1e-6)
    dx, dy = (x - x_p).abs()[0].numpy(), (y - y_p).abs()[0].numpy()
    frame = np.pad(img[0].to(torch.float32).numpy(), ((1, 1), (1, 1), (0, 0)))
    lx, ly = (float(np.abs(np.diff(frame, axis=a)).max()) for a in (1, 0))
    bound = lx * dx + ly * dy + 1e-6
    diff = np.abs(card_img - cpu_img).max(0)
    out = {"kernel_vs_plain": float(np.abs(card_img - plain).max()),
           "coords": float(max(dx.max(), dy.max())), "image": float(diff.max()),
           "lipschitz": [lx, ly], "bound_used": float((diff / bound).max())}
    if not kernel_ok or out["coords"] > 1e-3 or out["bound_used"] > 1.0:
        raise AssertionError(f"-f: warped image card vs CPU {out} (limits: kernel vs plain "
                             "rtol 1e-5 atol 1e-6, coordinates 1e-3 px, image within "
                             "Lx |dx| + Ly |dy| + 1e-6 per pixel)")
    return out


def photometric_arms_phase(torch, tmp: Path, card: str) -> dict:
    """Slice 7's arms of the self-supervised step on the card, DispNetS +
    PoseExpNet at 128x416, B=4, fp32: the default, ``--half-res-photo`` and
    ``--stochastic-photo 2`` through ``cli.train.main`` (5 steps and a
    validation without GT each), ``batch_refs`` through the step builder
    (5 steps). For each: the counted launches and problems (1 grouped
    forward and 1 grouped coordinate-only backward launch a step, of 8
    problems, 4 for ``batch_refs``; validation the default arm's 8), the
    profile's grouped launches a step and their device us, the arm's own
    problem list through the grouped kernels against the plain sampler
    (``_group_agrees``), one step card against CPU, and the step's ms (CUDA
    events over 20 steps) and busy ms. Then ``-f 1`` with a recording
    writer: the four images, one single-problem forward launch for the
    warped image, which is held against the CPU port's
    (``_warped_image_agrees``)."""
    from supervised_dispnet_tpu_torch.cli import train as train_cli
    from supervised_dispnet_tpu_torch.ops import warp as wp
    from supervised_dispnet_tpu_torch.ops.cuda import warp as kw
    from supervised_dispnet_tpu_torch.training import trainer as trainer_mod
    from supervised_dispnet_tpu_torch.training.train_step import make_selfsup_train_step
    from supervised_dispnet_tpu_torch.utils.profiling import steady_state_images_per_sec

    B, H, W = MAIN_SHAPE
    t0 = time.perf_counter()
    write_packed(tmp / "data", np.random.default_rng(31), H, W, with_depth=False)
    out, nets, batch = {}, None, None
    for arm, (flags, opts, problems) in PHOTO_ARMS.items():
        _warp_counts(kw, zero=True)
        if flags is not None:
            trainer = train_cli.main(_selfsup_argv(tmp / "data", tmp / "ckpt", arm, 5, *flags))
            torch.cuda.synchronize()
            launches = _warp_counts(kw)
            steps, val = trainer.step, len(trainer.make_loaders()[1])
            losses, _ = _read_run(trainer, steps)
            nets = nets or (trainer.model, trainer.pose_model)
            batch = _first_batch(trainer)

            def step(trainer=trainer):
                return trainer.train_step(batch)
        else:
            # no JAX CLI flag: the step builder, on the default run's nets
            disp, pose = (copy.deepcopy(m) for m in nets)
            built = make_selfsup_train_step(
                disp, pose, torch.optim.Adam([*disp.parameters(), *pose.parameters()],
                                             lr=2e-4), **opts)
            gen = torch.Generator(device="cuda").manual_seed(0)

            def step(built=built, gen=gen):
                return built(batch, gen)

            losses = [float(step()["loss"]) for _ in range(5)]
            torch.cuda.synchronize()
            launches, steps, val = _warp_counts(kw), 5, 0
        want = {"warp_fwd": steps + val, "warp_bwd": 0, "warp_bwd_coords": steps,
                "warp_fwd_problems": problems * steps + 8 * val,
                "warp_bwd_coords_problems": problems * steps}
        if steps != 5 or launches != want or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{arm} arm: launches {launches}, expected {want} over "
                                 f"{steps} steps and {val} validation batches; losses "
                                 f"{losses}")
        ips = steady_state_images_per_sec(step, B, torch.device("cuda"), iters=20, warmup=3)
        prof = profile_steps(torch, step, n=5, top=4)
        group = {k: [r for r in prof["own_kernels"] if k in r["kernel"]]
                 for k in ("warp_forward_group_kernel", "warp_backward_coords_group_kernel")}
        if any(len(r) != 1 or r[0]["calls_per_step"] != 1.0 for r in group.values()):
            raise AssertionError(f"{arm} arm: the profile shows grouped warp kernels "
                                 f"{group}, not one forward and one backward a step")
        probs = _arm_problems(torch, step, seed=40)
        if len(probs) != problems:
            raise AssertionError(f"{arm} arm: {len(probs)} sampling problems a step, "
                                 f"not {problems}")
        err_f, err_c = _group_agrees(torch, kw, f"{arm} arm", probs, "zeros")
        row = {"launches": launches, "train_losses": losses, "problems_per_launch": problems,
               "problem_shapes": [[list(i.shape), list(x.shape)] for i, x, _, _ in probs],
               "step_ms": B / ips * 1e3, "img_per_s": ips,
               "busy_ms": prof["busy_ms_per_step"],
               "fwd_group_us": group["warp_forward_group_kernel"][0]["us_per_call"],
               "bwd_group_us": group["warp_backward_coords_group_kernel"][0]["us_per_call"],
               "max_abs_err": {"out": err_f, "dx_dy": err_c},
               "cross_check": arm_cross_check(torch, arm) if arm != "default" else None}
        print(f"  {arm} arm: {row['step_ms']:.3f} ms a step ({ips:.1f} img/s), busy "
              f"{row['busy_ms']:.3f} ms; grouped warp {row['fwd_group_us']:.2f} + "
              f"{row['bwd_group_us']:.2f} us a launch, {problems} problems, "
              f"{[tuple(x.shape[1:]) for _, x, _, _ in probs[:2]]}...; on {card}", flush=True)
        out[arm] = row
        del probs
    base = out["default"]
    for arm, row in out.items():
        print(f"  arms: {arm} step {row['step_ms']:.3f} ms (default {base['step_ms']:.3f}), "
              f"busy {row['busy_ms']:.3f} ms (default {base['busy_ms']:.3f})", flush=True)

    # -f 1: the training-output images through the CLI, with a recording writer
    writer = RecordingWriter()
    made = trainer_mod.make_tensorboard_writer
    trainer_mod.make_tensorboard_writer = lambda path: writer
    try:
        _warp_counts(kw, zero=True)
        trainer = train_cli.main(_selfsup_argv(tmp / "data", tmp / "ckpt", "viz", 1, "-f", "1"))
        torch.cuda.synchronize()
    finally:
        trainer_mod.make_tensorboard_writer = made
    launches = _warp_counts(kw)
    val = len(trainer.make_loaders()[1])
    # the train step's grouped forward (8), the image's single forward (1)
    # and validation's grouped forwards (8 each)
    want = {"warp_fwd": 2 + val, "warp_bwd": 0, "warp_bwd_coords": 1,
            "warp_fwd_problems": 9 + 8 * val, "warp_bwd_coords_problems": 8}
    tags = {"train/disp", "train/input", "train/warped", "train/diff"}
    if launches != want or set(writer.images) != tags:
        raise AssertionError(f"-f 1: launches {launches}, expected {want}; images "
                             f"{sorted(writer.images)}")
    # the same images again, alone, beside the CPU port's on the same weights
    from supervised_dispnet_tpu_torch.training.trainer import Trainer, TrainerConfig

    loader = iter(trainer.make_loaders()[0])
    item = next(loader)
    loader.close()
    trainer.tb, cpu_writer = RecordingWriter(), RecordingWriter()
    cpu = Trainer(TrainerConfig(loss="selfsup", batch_size=B, save_path=str(tmp / "cpu")),
                  copy.deepcopy(trainer.model).cpu(), copy.deepcopy(trainer.pose_model).cpu(),
                  device="cpu")
    cpu.tb = cpu_writer
    seen, real_sample = {}, wp.sample

    def spy(img, x, y, *args, **kwargs):
        seen[img.device.type] = [t.detach().cpu() for t in (img, x, y)]
        return real_sample(img, x, y, *args, **kwargs)

    wp.sample = spy  # inverse_warp looks its sampler up at call time
    try:
        _warp_counts(kw, zero=True)
        trainer.log_images(item, 1)
        torch.cuda.synchronize()
        single = _warp_counts(kw)
        cpu.log_images(item, 1)
    finally:
        wp.sample = real_sample
    errs = {t: float(np.abs(trainer.tb.images[t] - cpu_writer.images[t]).max()) for t in tags}
    print(f"  -f 1: images {sorted(writer.images)}; one image's warp launches {single}; "
          f"card vs CPU max abs err {errs}", flush=True)
    if (single["warp_fwd"], single["warp_fwd_problems"]) != (1, 1) or sum(single.values()) != 2:
        raise AssertionError(f"-f: the warped image took launches {single}, not one "
                             "single-problem forward")
    # the input is uint8 / 255, which the card computes as a product with
    # 1 / 255: within an ulp of the CPU's quotient
    if errs["train/input"] > 1e-6:
        raise AssertionError(f"-f: card vs CPU input images differ by {errs['train/input']} "
                             "(limit 1e-6)")
    warped = _warped_image_agrees(torch, trainer.tb.images["train/warped"],
                                  cpu_writer.images["train/warped"], seen,
                                  trainer.cfg.padding_mode)
    print(f"  -f 1: warped image, kernel vs plain sampler at the card's coordinates "
          f"{warped['kernel_vs_plain']:.3g}; coordinates card vs CPU {warped['coords']:.3g} "
          f"px; card vs CPU image {warped['image']:.3g}, at most "
          f"{warped['bound_used']:.3f} of its per-pixel bound", flush=True)
    out["viz"] = {"launches": launches, "single_image_launches": single,
                  "card_vs_cpu_max_abs_err": errs, "warped": warped}
    out["seconds"] = time.perf_counter() - t0
    print(f"  photometric arms phase: {out['seconds']:.1f} s", flush=True)
    return out


@contextlib.contextmanager
def counted_readbacks(torch):
    """Counts ``float()`` of a CUDA tensor (the trainer's readback of a
    step's metrics) inside the block: yields a one-item list."""
    n, real = [0], torch.Tensor.__float__

    def counted(t):
        n[0] += t.is_cuda
        return real(t)

    torch.Tensor.__float__ = counted
    try:
        yield n
    finally:
        torch.Tensor.__float__ = real


def _dispatch_run(torch, data: Path, tmp: Path, k: int, steps: int = 4) -> tuple:
    """One epoch of ``steps`` self-supervised steps from the seeded nets with
    ``--loader device`` and k steps a dispatch, through ``Trainer``; returns
    (the parameters before it, the parameters after it, the logged losses,
    the readbacks)."""
    from supervised_dispnet_tpu_torch.models import DispNetS, PoseExpNet
    from supervised_dispnet_tpu_torch.training.trainer import Trainer, TrainerConfig
    from supervised_dispnet_tpu_torch.utils.logging import CsvLogger, JsonlLogger, TermLogger

    trainer = Trainer(TrainerConfig(data=str(data), save_path=str(tmp), loss="selfsup",
                                    batch_size=MAIN_SHAPE[0], epoch_size=steps, loader="device",
                                    steps_per_dispatch=k),
                      DispNetS(generator=torch.Generator().manual_seed(0)),
                      PoseExpNet(generator=torch.Generator().manual_seed(1)))
    nets = (trainer.model, trainer.pose_model)
    init = [p.detach().clone() for net in nets for p in net.parameters()]
    loader = trainer.make_loaders()[0]
    jsonl = JsonlLogger(tmp / "metrics.jsonl")
    with counted_readbacks(torch) as readbacks:
        trainer.train_epoch(loader, TermLogger(1, len(loader), 1), CsvLogger(tmp), jsonl)
    jsonl.close()
    losses = [json.loads(x)["loss"] for x in (tmp / "metrics.jsonl").read_text().splitlines()]
    params = [p.detach().clone() for net in nets for p in net.parameters()]
    if trainer.update.micro_step != steps:
        raise AssertionError(f"k={k}: {trainer.update.micro_step} steps, not {steps}")
    return init, params, losses, readbacks[0]


def dispatch_gap(torch, run, ref) -> float:
    """How far ``run``'s parameters lie from ``ref``'s, as a share of how
    far ``ref``'s steps moved them: ||theta_run - theta_ref|| / ||theta_ref -
    theta_0||, over every parameter of both nets at once (``_dispatch_run``'s
    tuples, from the same seeded start)."""
    flat = [torch.cat([p.flatten() for p in ps]) for ps in (run[1], ref[1], ref[0])]
    return float((flat[0] - flat[1]).norm() / (flat[1] - flat[2]).norm())


def device_loader_phase(torch, tmp: Path, card: str) -> dict:
    """``--loader device`` on the card (the packed split resident as uint8,
    each batch gathered there): its batches against ``--loader threads``'s,
    bit for bit, over an epoch of the smoke split; 5 self-supervised steps
    through ``cli.train.main`` with each (losses within rel 1e-4: the card's
    step is not bit-reproducible, ROADMAP.md C4, and the losses after the
    first carry that); ``--steps-per-dispatch 4`` through ``Trainer``
    against 4 single steps (the parameters within 5% of the way the single
    steps moved them, ``dispatch_gap``: the card's step is not
    bit-reproducible; the logged loss the mean of the four, rel 1e-4; one
    readback per 4 steps), and 5 steps as one dispatch through the
    CLI (its logged loss the mean of ``--loader threads``' five, rel 1e-4);
    DispResNet-50 BerHu with ``--loader device -j 2 --steps-per-dispatch 3``
    through the CLI (1 + 1 BerHu launches a step)."""
    from supervised_dispnet_tpu_torch.cli import train as train_cli
    from supervised_dispnet_tpu_torch.ops.cuda import losses as kl
    from supervised_dispnet_tpu_torch.ops.cuda import warp as kw

    B, H, W = MAIN_SHAPE
    t0 = time.perf_counter()
    write_packed(tmp / "data", np.random.default_rng(33), H, W, with_depth=False)
    runs = {}
    for loader in ("threads", "device"):
        _warp_counts(kw, zero=True)
        trainer = train_cli.main(_selfsup_argv(tmp / "data", tmp / "ckpt", loader, 5,
                                               "--loader", loader, "-j", "2"))
        torch.cuda.synchronize()
        batches = []
        for item in trainer.make_loaders()[0]:
            batches.append(trainer.prep_train_batch(item))
        runs[loader] = {"trainer": trainer, "batches": batches, "launches": _warp_counts(kw),
                        "losses": _read_run(trainer, trainer.step)[0]}
    a, b = runs["threads"], runs["device"]
    same = len(a["batches"]) == len(b["batches"]) == 5 and all(
        x.keys() == y.keys() and all(x[n].dtype == y[n].dtype and torch.equal(x[n], y[n])
                                     for n in x)
        for x, y in zip(a["batches"], b["batches"]))
    loss_rel = max(abs(x - y) / abs(x) for x, y in zip(a["losses"], b["losses"]))
    print(f"  --loader device vs threads: {len(b['batches'])} batches bit-equal {same} "
          f"({sorted(b['batches'][0])}); losses {b['losses']} vs {a['losses']}, max rel "
          f"{loss_rel:.3g}; launches {b['launches']} vs {a['launches']}", flush=True)
    if not same or loss_rel > 1e-4 or a["launches"] != b["launches"]:
        raise AssertionError("--loader device: batches, losses (limit rel 1e-4) or launches "
                             "differ from --loader threads")
    # the same 5 steps as one dispatch through the CLI: one logged mean
    _warp_counts(kw, zero=True)
    trainer = train_cli.main(_selfsup_argv(tmp / "data", tmp / "ckpt", "k5", 5, "--loader",
                                           "device", "-j", "2", "--steps-per-dispatch", "5"))
    torch.cuda.synchronize()
    k5 = [json.loads(x) for x in
          (Path(trainer.cfg.save_path) / "metrics.jsonl").read_text().splitlines()]
    k5 = [(e["step"], e["loss"]) for e in k5 if e["event"] == "train_iter"]
    k5_rel = abs(k5[0][1] - np.mean(a["losses"])) / abs(np.mean(a["losses"]))
    print(f"  --steps-per-dispatch 5 through the CLI: logged {k5} (rel {k5_rel:.3g} to the "
          f"mean of --loader threads' losses); launches {_warp_counts(kw)}", flush=True)
    if (trainer.step != 5 or [s for s, _ in k5] != [5] or k5_rel > 1e-4
            or _warp_counts(kw) != a["launches"]):
        raise AssertionError("--steps-per-dispatch 5 through the CLI: steps, logged mean "
                             "(limit rel 1e-4) or launches off")

    # The card's step is not bit-reproducible (ROADMAP.md C4), so the block
    # cannot equal 4 single steps bit for bit, and how far two runs of the
    # same steps part is itself random: scripts/torch_dispatch_spread.py
    # measured 0.07-1.01% of the way the steps moved the parameters on an
    # H100, while one step too few lies 22% away. So the block must lie
    # within 5%.
    singles = [_dispatch_run(torch, tmp / "data", tmp / f"k1_{n}", 1) for n in range(2)]
    single = singles[0]
    block = _dispatch_run(torch, tmp / "data", tmp / "k4", 4)
    gap = max(dispatch_gap(torch, block, s) for s in singles)
    spread = dispatch_gap(torch, singles[1], single)
    mean_rel = abs(block[2][0] - np.mean(single[2])) / abs(np.mean(single[2]))
    print(f"  --steps-per-dispatch 4: parameters vs 4 single steps {gap:.3g} of the steps' "
          f"movement (limit 0.05; two single runs part by {spread:.3g}); logged loss "
          f"{block[2]} vs the mean of {single[2]} (rel {mean_rel:.3g}); readbacks {block[3]} "
          f"for 4 steps (single: {single[3]})", flush=True)
    if gap > 0.05 or mean_rel > 1e-4 or block[3] != 1 or single[3] != 4:
        raise AssertionError(f"--steps-per-dispatch 4: parameters ({gap:.3g} of the movement, "
                             f"limit 0.05), logged loss (rel {mean_rel:.3g}, limit 1e-4) or "
                             f"readbacks ({block[3]}, {single[3]}) off")

    write_packed(tmp / "sdata", np.random.default_rng(34), H, W)
    kl.berhu_fwd_launches = kl.berhu_bwd_launches = kl.berhu_fwd_problems = 0
    trainer = train_cli.main([str(tmp / "sdata"), "--network", "disp_res_50", "--loss", "berhu",
                              "-b", str(B), "--epoch-size", "3", "--epochs", "1",
                              "--loader", "device", "-j", "2", "--steps-per-dispatch", "3",
                              "--checkpoints-dir", str(tmp / "ckpt"), "--name", "berhu"])
    torch.cuda.synchronize()
    berhu = {"berhu_fwd": kl.berhu_fwd_launches, "berhu_bwd": kl.berhu_bwd_launches,
             "berhu_fwd_problems": kl.berhu_fwd_problems}
    losses, epoch = _read_run(trainer, 1)  # one logged mean for the 3 steps
    print(f"  --loader device --steps-per-dispatch 3 BerHu DispResNet-50: {trainer.step} "
          f"steps, launches {berhu}, logged loss {losses}, val abs_rel "
          f"{epoch['abs_rel']:.4f}", flush=True)
    if trainer.step != 3 or berhu != {"berhu_fwd": 3, "berhu_bwd": 3, "berhu_fwd_problems": 12}:
        raise AssertionError(f"--loader device BerHu: launches {berhu}")
    out = {"batches_bit_equal": same, "loss_max_rel": loss_rel,
           "losses": {k: r["losses"] for k, r in runs.items()},
           "dispatch": {"params_gap_over_movement": gap, "single_spread": spread,
                        "logged": block[2], "single_losses": single[2],
                        "readbacks": {"k4": block[3], "k1": single[3]},
                        "cli_k5": {"logged": k5, "rel_to_threads_mean": k5_rel}},
           "berhu": {"launches": berhu, "losses": losses}, "card": card}
    out["seconds"] = time.perf_counter() - t0
    print(f"  device loader phase: {out['seconds']:.1f} s", flush=True)
    return out


ETL_RAW = (375, 1242)  # KITTI raw's frame size
ETL_DRIVES, ETL_FRAMES, ETL_STATIC = 3, 24, 2
BLOCKED = ("cv2", "PIL", "imageio", "joblib", "jax", "supervised_dispnet_tpu")


def run_blocked(module: str, args: list[str]) -> float:
    """``python -m module args`` in a subprocess with the image libraries,
    joblib and JAX blocked in ``sys.modules`` (the card's machine has none
    of them; this makes sure nothing reaches for them); its wall seconds."""
    code = (f"import runpy, sys\nfor m in {BLOCKED!r}:\n    sys.modules[m] = None\n"
            f"sys.argv = [{module!r}] + sys.argv[1:]\n"
            f"runpy.run_module({module!r}, run_name='__main__')\n")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, check=True)
    return time.perf_counter() - t0


def _png_unfilter_ms(path: Path, reps: int = 5) -> dict:
    """A PNG frame's decode by ``read_png`` (zlib + the native unfilter)
    beside zlib + the plain numpy unfilter, ms each (best of ``reps``)."""
    import struct
    import zlib

    from supervised_dispnet_tpu_torch.utils import image_io

    data = path.read_bytes()
    chunks = list(image_io._chunks(data, path))
    W, H = struct.unpack(">II", chunks[0][1][:8])
    idat = b"".join(p for k, p in chunks if k == b"IDAT")

    def best(fn) -> float:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    def plain():
        raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, W * 3 + 1)
        return image_io._unfilter(raw[:, 1:].reshape(H, W, 3), raw[:, 0], 3)

    if not np.array_equal(plain(), image_io.read_png(path)):
        raise AssertionError(f"{path}: the native and numpy PNG unfilters disagree")
    return {"native_ms": best(lambda: image_io.read_png(path)), "plain_ms": best(plain)}


def _loader_img_s(dataset, workers: int, epochs: int = 3) -> float:
    """Frames a second that ``BatchLoader`` hands on over ``epochs`` epochs
    (the target and its references), decode included."""
    from supervised_dispnet_tpu_torch.data.loader import BatchLoader

    loader = BatchLoader(dataset, MAIN_SHAPE[0], shuffle=True, num_workers=workers)
    t0, frames = time.perf_counter(), 0
    for _ in range(epochs):
        for batch in loader:
            frames += batch["tgt"].shape[0] * (1 + batch["ref_imgs"].shape[1])
    return frames / (time.perf_counter() - t0)


def _step_img_s(torch, trainer) -> float:
    """Images a second of the trainer's step on its first batch (CUDA
    events over 10 steps after 2 of warm-up)."""
    batch = _first_batch(trainer)
    return MAIN_SHAPE[0] / cuda_ms(torch, lambda: trainer.train_step(batch), reps=10,
                                   warmup=2) * 1e3


def etl_phase(torch, tmp: Path, card: str, device: str = "cuda") -> dict:
    """The reference's data path on the card's machine (slice 8): a
    synthetic KITTI-raw tree (3 drives x 24 frames at 375x1242, velodyne,
    oxts, 2 static frames a drive) and an odometry sequence, dumped by
    ``python -m supervised_dispnet_tpu_torch.data.prepare_train_data``
    (``--with-depth --with-pose``, 128x416) in a subprocess with cv2, PIL,
    imageio, joblib and JAX blocked; configs 3 (DispResNet-50 BerHu, ``-j
    4``) and 5 (DispNetS + PoseExpNet self-supervised) trained 5 steps each
    through ``cli.train.main`` from the JPEG dump tree (BerHu grouped 1 + 1
    launches a step, warp grouped 1 + 1); the dump packed by the port's pack
    CLI, the folder and packed loaders' first train and val batches bit for
    bit, and config 3's first logged loss from each within rel 1e-6 (the
    same seed, the same batch); the host's native and plain PNG decode of a
    375x1242 frame, JPEG decode and encode of a 128x416 frame, the folder
    loader's frames a second at ``-j 1`` and ``-j 4`` (and the packed
    loader's) beside the step's images a second; folder inference over the
    dump's JPEGs on the card."""
    from supervised_dispnet_tpu_torch.cli import run_inference
    from supervised_dispnet_tpu_torch.cli import train as train_cli
    from supervised_dispnet_tpu_torch.data.packed import PackedSequenceDataset, is_packed
    from supervised_dispnet_tpu_torch.data.sequence_folders import SequenceFolder
    from supervised_dispnet_tpu_torch.kitti_eval.synthetic import (
        write_kitti_odometry, write_kitti_raw)
    from supervised_dispnet_tpu_torch.ops.cuda import losses as kl
    from supervised_dispnet_tpu_torch.ops.cuda import warp as kw
    from supervised_dispnet_tpu_torch.utils.image_io import (
        decode_image, encode_jpeg, read_image)

    B, H, W = MAIN_SHAPE
    t0 = time.perf_counter()
    write_kitti_raw(tmp / "raw", seed=21, drives=ETL_DRIVES, frames=ETL_FRAMES,
                    height=ETL_RAW[0], width=ETL_RAW[1], oxts=True, static_frames=ETL_STATIC)
    write_kitti_odometry(tmp / "odometry", seed=22, seq="00", frames=ETL_FRAMES,
                         height=ETL_RAW[0], width=ETL_RAW[1], calib=True)
    print(f"  etl: synthetic raw tree ({ETL_DRIVES} x {ETL_FRAMES} frames) and odometry "
          f"sequence in {time.perf_counter() - t0:.2f} s", flush=True)

    dump, odo_dump, packed = tmp / "dump", tmp / "odo_dump", tmp / "packed"
    etl_s = run_blocked("supervised_dispnet_tpu_torch.data.prepare_train_data", [
        str(tmp / "raw"), "--dump-root", str(dump), "--with-depth", "--with-pose",
        "--height", str(H), "--width", str(W), "--static-frames",
        str(tmp / "raw" / "static_frames.txt"), "--num-threads", "4"])
    odo_s = run_blocked("supervised_dispnet_tpu_torch.data.prepare_train_data", [
        str(tmp / "odometry"), "--dataset-format", "odometry", "--dump-root", str(odo_dump),
        "--with-pose", "--height", str(H), "--width", str(W), "--num-threads", "4"])
    jpgs = sorted(dump.glob("*/*.jpg"))
    n_kitti = ETL_DRIVES * (ETL_FRAMES - ETL_STATIC)
    scenes = sorted(d.name for d in dump.iterdir() if d.is_dir())
    if (len(jpgs) != n_kitti or len(list(dump.glob("*/*.npy"))) != n_kitti
            or len(scenes) != ETL_DRIVES or len(list(odo_dump.glob("seq_00/*.jpg"))) != ETL_FRAMES
            or read_image(jpgs[0]).shape != (H, W, 3)):
        raise AssertionError(f"etl: {len(jpgs)} frames in {scenes}, odometry "
                             f"{len(list(odo_dump.glob('seq_00/*.jpg')))}")
    for scene in scenes:
        poses = np.loadtxt(dump / scene / "poses.txt")
        if poses.shape != (ETL_FRAMES - ETL_STATIC, 12) or not np.isfinite(poses).all():
            raise AssertionError(f"etl: {scene}/poses.txt {poses.shape}")
    print(f"  etl: prepare_train_data {n_kitti} KITTI frames in {etl_s:.3f} s "
          f"({etl_s / n_kitti:.4f} s a frame), odometry {ETL_FRAMES} frames in {odo_s:.3f} s "
          f"({odo_s / ETL_FRAMES:.4f} s a frame), cv2 / PIL / imageio / joblib / JAX blocked",
          flush=True)

    # configs 3 and 5 from the JPEG dump tree, through the CLI
    runs = {}
    for name, argv, counters, per_step in (
            ("berhu", ["--network", "disp_res_50", "--loss", "berhu", "--with-gt", "-j", "4"],
             (kl, {"berhu_fwd": "berhu_fwd_launches", "berhu_bwd": "berhu_bwd_launches",
                   "berhu_fwd_problems": "berhu_fwd_problems"}),
             {"berhu_fwd": 1, "berhu_bwd": 1, "berhu_fwd_problems": 4}),
            ("selfsup", ["--network", "dispnet", "--loss", "selfsup", "--sequence-length", "3",
                         "-p", "1.0", "-m", "0.2", "-s", "0.1", "-j", "4"],
             (kw, {"warp_fwd": "warp_fwd_launches", "warp_bwd_coords": "warp_bwd_coords_launches",
                   "warp_fwd_problems": "warp_fwd_problems",
                   "warp_bwd_coords_problems": "warp_bwd_coords_problems"}),
             {"warp_fwd": 1, "warp_bwd_coords": 1, "warp_fwd_problems": 8,
              "warp_bwd_coords_problems": 8})):
        mod, attrs = counters
        for attr in attrs.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        trainer = train_cli.main([str(dump), *argv, "-b", str(B), "--epoch-size", "5",
                                  "--epochs", "1", "--device", device, "--checkpoints-dir",
                                  str(tmp / "ckpt"), "--name", f"etl_{name}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: getattr(mod, a) for k, a in attrs.items()}
        steps = trainer.step
        # validation has GT here, so the self-supervised run's validation
        # runs no warp; neither runs BerHu
        want = {k: v * steps for k, v in per_step.items()}
        print(f"  etl: {name} from the JPEG dump, {steps} steps in {wall:.2f} s; launches "
              f"{launches}", flush=True)
        if steps != 5 or launches != want or not trainer.val_with_gt:
            raise AssertionError(f"etl {name}: expected launches {want} over {steps} "
                                 f"steps (val with GT {trainer.val_with_gt}), got {launches}")
        losses, _ = _read_run(trainer, steps)
        runs[name] = {"trainer": trainer, "launches": launches, "losses": losses,
                      "wall_s": wall}

    # pack the dump with the port's CLI; the folder and packed batches
    pack_s = run_blocked("supervised_dispnet_tpu_torch.data.packed", [str(dump), str(packed)])
    if not is_packed(packed):
        raise AssertionError("etl: the pack CLI wrote no packed root")
    trainer = runs["berhu"]["trainer"]
    folder_loaders = trainer.make_loaders()
    trainer.cfg = dataclasses.replace(trainer.cfg, data=str(packed))
    packed_loaders = trainer.make_loaders()
    trainer.cfg = dataclasses.replace(trainer.cfg, data=str(dump))
    for kind, a, b in zip(("train", "val"), folder_loaders, packed_loaders):
        fa, fb = iter(a), iter(b)
        x, y = next(fa), next(fb)
        fa.close()
        fb.close()
        if sorted(x) != sorted(y) or not all(
                x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]) for k in x):
            raise AssertionError(f"etl: the folder and packed loaders' first {kind} "
                                 "batches differ")
    packed_run = train_cli.main([str(packed), "--network", "disp_res_50", "--loss", "berhu",
                                 "--with-gt", "-b", str(B), "--epoch-size", "2", "--epochs",
                                 "1", "--device", device, "--checkpoints-dir",
                                 str(tmp / "ckpt"), "--name", "etl_packed"])
    first = (runs["berhu"]["losses"][0], _read_run(packed_run, 2)[0][0])
    loss_rel = abs(first[0] - first[1]) / abs(first[1])
    print(f"  etl: packed in {pack_s:.3f} s; first train and val batches bit-equal; first "
          f"loss folder {first[0]!r} packed {first[1]!r} (rel {loss_rel:.3g}, limit 1e-6)",
          flush=True)
    if loss_rel > 1e-6:
        raise AssertionError(f"etl: first losses {first}")

    # host costs
    png = _png_unfilter_ms(sorted((tmp / "raw").glob("*/*/image_02/data/*.png"))[0])
    frame = read_image(jpgs[0])
    data = jpgs[0].read_bytes()
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        decode_image(data)
    jpeg_dec = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        encode_jpeg(frame)
    jpeg_enc = (time.perf_counter() - t0) / reps * 1e3
    seq = dict(seed=0, train=True, sequence_length=1, with_depth=True, uint8=True)
    loader_img_s = {f"folder_j{j}": _loader_img_s(SequenceFolder(dump, **seq), j)
                    for j in (1, 4)}
    loader_img_s["packed_j4"] = _loader_img_s(PackedSequenceDataset(packed, **seq), 4)
    step_img_s = {n: _step_img_s(torch, runs[n]["trainer"]) for n in ("berhu", "selfsup")}
    host = {"png_375x1242": png, "jpeg_decode_ms_128x416": jpeg_dec,
            "jpeg_encode_ms_128x416": jpeg_enc, "loader_frames_per_s": loader_img_s,
            "step_img_s": step_img_s}
    print(f"  etl host: PNG 375x1242 decode native {png['native_ms']:.3f} ms, plain "
          f"{png['plain_ms']:.3f} ms; JPEG 128x416 decode {jpeg_dec:.3f} ms, encode "
          f"{jpeg_enc:.3f} ms; loader frames/s {loader_img_s}; step img/s {step_img_s}, "
          f"on {card}", flush=True)

    # folder inference over the dump's JPEGs on the card
    scene = dump / scenes[0]
    t0 = time.perf_counter()
    run_inference.main(["--pretrained", str(Path(trainer.cfg.save_path)
                                            / "dispnet_checkpoint.pth.tar"),
                        "--network", "disp_res_50", "--dataset-dir", str(scene),
                        "--output-dir", str(tmp / "infer_jpg"), "--img-height", str(H),
                        "--img-width", str(W), "--save-npy", "--device", device])
    infer_s = time.perf_counter() - t0
    depths = sorted((tmp / "infer_jpg").glob("*_depth.npy"))
    n_scene = len(list(scene.glob("*.jpg")))
    if len(depths) != n_scene or not all(
            np.isfinite(d := np.load(p)).all() and d.shape == (H, W) for p in depths):
        raise AssertionError(f"etl: inference wrote {len(depths)} depths for {n_scene} JPEGs")
    print(f"  etl: run_inference over {n_scene} JPEGs in {infer_s:.3f} s", flush=True)
    return {"etl_s": etl_s, "etl_s_per_frame": etl_s / n_kitti, "frames": n_kitti,
            "odometry_s_per_frame": odo_s / ETL_FRAMES, "pack_s": pack_s,
            "launches": {n: r["launches"] for n, r in runs.items()},
            "losses": {n: r["losses"] for n, r in runs.items()},
            "train_wall_s": {n: r["wall_s"] for n, r in runs.items()},
            "first_loss_rel_folder_vs_packed": loss_rel, "host": host,
            "inference_s": infer_s, "card": card}


CONVERGENCE_RUNS = {  # the short form of scripts/torch_convergence_check.py
    "supervised": ["--steps", "60", "--eval-every", "30"],
    "selfsup": ["--loss", "selfsup", "--steps", "60", "--batch", "8", "--pool", "2",
                "--eval-every", "30"],
}


def convergence_phase(torch) -> dict:
    """``scripts/torch_convergence_check.py`` for a few dozen steps of each
    task on the card: its initial and final metrics. The supervised val
    abs_rel must halve (on the H100: 0.994 -> 0.229 in 60 steps, 0.092 in
    300; PERF.md); the self-supervised metrics only finite: 60 steps sit in
    the task's early transient (0.337 -> 0.334, its ATE up; 600 steps 0.308)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_convergence_check", REPO / "scripts" / "torch_convergence_check.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = {}
    for name, argv in CONVERGENCE_RUNS.items():
        r = script.main(argv)
        out[name] = {k: r[k] for k in ("initial", "final", "seconds", "steps", "batch")}
    sup, selfsup = out["supervised"], out["selfsup"]
    finite = all(math.isfinite(v) for m in (selfsup["initial"], selfsup["final"])
                 for v in m.values())
    if not (sup["final"] < 0.5 * sup["initial"]) or not finite:
        raise AssertionError(f"convergence: supervised abs_rel {sup['initial']:.4f} -> "
                             f"{sup['final']:.4f} (must halve); self-supervised {selfsup}")
    return out


def inverse_warp_phase(torch, device: str = "cuda") -> dict:
    """``ops.warp.inverse_warp`` as a user calls it, with its default
    ``diff_img=True``, at the main path's shape, and a backward into the
    image, depth and pose: the image+coordinate kernel's path. Held against
    the same call with the plain sampler on the card (the geometry is the
    same code on the same device): warped rtol 1e-5 / atol 1e-6; depth and
    pose gradients rtol 1e-4 of the largest; the image gradient rtol 1e-4 /
    atol 1e-5 (atomics). Then a profile of the call with its backward, for
    the image+coordinate kernel's device time."""
    from supervised_dispnet_tpu_torch.ops import warp as wp
    from supervised_dispnet_tpu_torch.ops.cuda import warp as kw
    from supervised_dispnet_tpu_torch.ops.sampling import bilinear_sample

    B, H, W = MAIN_SHAPE
    gen = torch.Generator().manual_seed(5)
    img = (torch.rand(B, H, W, 3, generator=gen) * 2 - 1).to(device)
    depth = (1.0 / (10.0 * torch.sigmoid(torch.randn(B, H, W, generator=gen)) + 0.01)).to(device)
    pose = (0.02 * torch.randn(B, 6, generator=gen)).to(device)
    K = torch.tensor(KITTI_K).expand(B, 3, 3).contiguous().to(device)
    cot = (torch.rand(B, H, W, 3, generator=gen) * 2 - 1).to(device)

    def run():
        ins = [t.clone().requires_grad_(True) for t in (img, depth, pose)]
        warped, valid = wp.inverse_warp(ins[0], ins[1], ins[2], K)
        grads = torch.autograd.grad((warped * cot * valid[..., None]).sum(), ins)
        return warped.detach(), grads

    kw.warp_fwd_launches = kw.warp_bwd_launches = kw.warp_bwd_coords_launches = 0
    warped_k, grads_k = run()
    torch.cuda.synchronize()
    launches = {"warp_fwd": kw.warp_fwd_launches, "warp_bwd": kw.warp_bwd_launches,
                "warp_bwd_coords": kw.warp_bwd_coords_launches}
    if launches != {"warp_fwd": 1, "warp_bwd": 1, "warp_bwd_coords": 0}:
        raise AssertionError(f"inverse_warp launched {launches}")
    kernel_sample = wp.sample
    wp.sample = lambda i, x, y, mode, diff_img: bilinear_sample(i, x, y, mode)
    try:
        warped_p, grads_p = run()
    finally:
        wp.sample = kernel_sample
    errs = {"warped": float((warped_k - warped_p).abs().max())}
    ok = torch.allclose(warped_k, warped_p, rtol=1e-5, atol=1e-6)
    for name, a, b, atol in zip(("img", "depth", "pose"), grads_k, grads_p,
                                (1e-5, None, None)):
        scale = float(b.abs().max())
        ok &= torch.allclose(a, b, rtol=1e-4, atol=atol if atol else 1e-4 * scale)
        errs[name] = float((a - b).abs().max()) / max(scale, 1e-30)
    print(f"  inverse_warp path: launches {launches}; max abs err warped "
          f"{errs['warped']:.3g}; grad max err / max|g| img {errs['img']:.3g}, depth "
          f"{errs['depth']:.3g}, pose {errs['pose']:.3g}", flush=True)
    if not ok:
        raise AssertionError(f"inverse_warp with the kernels disagrees with the plain "
                             f"sampler: {errs}")
    return {"launches": launches, "errors": errs,
            "profile": profile_steps(torch, run, top=4)}


# the port's own kernels' names in a profile (csrc/*.cu)
OWN_KERNELS = ("berhu_forward_group_kernel", "berhu_backward_group_kernel",
               "warp_forward_group_kernel", "warp_backward_", "ce_forward_kernel",
               "ce_backward_kernel")
# any kernel of csrc/ce.cu, this design's or another's, in a profile
CE_KERNEL = "::ce_"


def profile_steps(torch, step, n: int = 5, top: int = 12, count: tuple[str, ...] = ()) -> dict:
    """Device time of ``n`` steps by kernel, from ``torch.profiler``: the
    busy share of the steps' wall time, the ``top`` kernels by total device
    time, the port's own kernels (their device time alone, where the
    CUDA-event times of the kernel phase include the host's call), and for
    each name fragment in ``count`` the launches a step of the kernels whose
    names hold it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side ranges of user annotations (the optimizer's step) overlap
    # the kernels they hold: count kernels only
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    def row(e):
        return {"kernel": e.key[:90], "calls_per_step": e.count / n,
                "ms_per_step": e.self_device_time_total / n / 1e3,
                "us_per_call": e.self_device_time_total / max(e.count, 1)}

    rows = [row(e) for e in kernels[:top]]
    own = [row(e) for e in kernels
           if CE_KERNEL in e.key or any(k in e.key for k in OWN_KERNELS)]
    print(f"  profile over {n} steps: device busy {busy_us / n / 1e3:.3f} ms of "
          f"{wall_us / n / 1e3:.3f} ms a step ({busy_us / wall_us:.1%}); "
          f"{len(kernels)} kernels", flush=True)
    for r in rows:
        print(f"    {r['ms_per_step']:8.3f} ms  x{r['calls_per_step']:<5g} {r['kernel']}",
              flush=True)
    for r in own:
        print(f"    own kernel: {r['kernel']}: x{r['calls_per_step']:g} a step, "
              f"{r['us_per_call']:.2f} us a call on the device", flush=True)
    out = {"steps": n, "wall_ms_per_step": wall_us / n / 1e3,
           "busy_ms_per_step": busy_us / n / 1e3, "top": rows, "own_kernels": own,
           "launches_per_step": sum(e.count for e in kernels) / n}
    if count:
        out["counts"] = {c: sum(e.count for e in kernels if c in e.key) / n for c in count}
    return out


def _grads_agree(g, ref, rtol: float = 1e-3) -> tuple[bool, float]:
    """|g - ref| <= rtol * |ref| + rtol * max|ref| elementwise; also returns
    the worst excess over that bound, relative to max|ref|."""
    scale = max(float(ref.abs().max()), 1e-30)
    excess = (g - ref).abs() - rtol * ref.abs()
    return bool((excess <= rtol * scale).all()), float(excess.max()) / scale


def _rel_l2(g, ref) -> float:
    return float((g - ref).norm() / ref.norm().clamp(min=1e-30))


def bn_cancelled_biases(torch, model) -> dict:
    """{bias name: its conv's weight name} of each conv whose output goes
    straight into a BatchNorm (VGG-BN's encoder, FCRN's decoder): train-mode
    BN subtracts the batch mean, so the bias's gradient is 0 analytically
    and what either side computes is rounding."""
    mods = list(model.named_modules())
    return {f"{name}.bias": f"{name}.weight"
            for (name, m), (_, nxt) in zip(mods, mods[1:])
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None
            and isinstance(nxt, torch.nn.BatchNorm2d)}


def _one_step(torch, model, batch: dict, device, plain: bool = False, loss: str = "berhu"):
    """One supervised train step (BerHu, or the 64-bin classification CE),
    augmentation off; ``plain=True`` swaps the plain BerHu and CE in for the
    kernels. Returns (loss, {name: grad} on the CPU)."""
    from supervised_dispnet_tpu_torch.data.augment import AugmentConfig
    from supervised_dispnet_tpu_torch.losses.classification import (
        depth_classification_loss_plain)
    from supervised_dispnet_tpu_torch.losses.supervised import berhu_loss_plain
    from supervised_dispnet_tpu_torch.training import train_step as ts

    no_aug = AugmentConfig(flip=False, scale_crop=False, color_jitter=False)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    kernels = ts.SUPERVISED_LOSSES["berhu"], ts.CLASSIFICATION_CE
    if plain:
        ts.SUPERVISED_LOSSES["berhu"] = berhu_loss_plain
        ts.CLASSIFICATION_CE = depth_classification_loss_plain
    try:
        step = ts.make_supervised_train_step(model, opt, loss, aug=no_aug)
    finally:
        ts.SUPERVISED_LOSSES["berhu"], ts.CLASSIFICATION_CE = kernels
    loss = step({k: torch.from_numpy(v).to(device) for k, v in batch.items()})["loss"]
    return float(loss), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


# (label, DispResNet arguments, loss, the other side's device or None for
# the card, its name) of each supervised cross-check
SUPERVISED_CHECKS = (
    ("DispResNet-50", {"encoder_depth": 50}, "berhu", None, "card plain"),
    ("DispResNet-50", {"encoder_depth": 50}, "berhu", "cpu", "cpu"),
    ("DispResNet-18", {"encoder_depth": 18}, "berhu", "cpu", "cpu"),
    ("DispResNet-50 classification", {"encoder_depth": 50, "head": "classification"},
     "classification", None, "card plain"),
    ("DispResNet-50 classification", {"encoder_depth": 50, "head": "classification"},
     "classification", "cpu", "cpu"),
    ("DispResNet-50 multi-scale classification",
     {"encoder_depth": 50, "head": "classification", "multiscale_classification": True},
     "classification", None, "card plain"),
    ("DispVggBN", {"network": "disp_vgg_bn"}, "berhu", "cpu", "cpu"),
    ("FCRN", {"network": "fcrn"}, "berhu", "cpu", "cpu"),
)
# the parameters held by relative L2 (ROADMAP.md C4) against the CPU, by
# name prefix: those whose gradients a train-mode BN spreads a ReLU flip
# over. Every network's encoder; for FCRN, whose ResNet-50 sits at the root
# of its state dict, also the 1x1 reduction and the up-projections, each
# ahead of a BN of a small map (4x13 .. 64x208 at B = 4)
BN_SPREAD_PREFIXES = {"fcrn": ("conv1.", "bn1.", "layer", "conv2.", "bn2.", "up")}


def cross_check(torch, device: str = "cuda", checks=SUPERVISED_CHECKS) -> dict:
    """One supervised train step at the main-path shape from identical
    weights on one batch, augmentation off, TF32 off for cuDNN and matmul,
    for each of ``checks``: BerHu and the 64-bin classification CE
    (single- and multi-scale) on DispResNet, BerHu on VGG-BN and FCRN. Loss
    rtol 1e-4; gradients rtol 1e-3 (``_grads_agree``: the two sides sum in
    other orders).

    - DispResNet-50 on the card, with the kernels against the plain BerHu
      or CE: the same convolutions on the same device, so every gradient
      must agree and only the loss kernels differ.
    - Card (kernels) against CPU (plain): the loss and the decoder's and
      heads' gradients (a conv bias ahead of a BatchNorm has a gradient of
      0 analytically: ``bn_cancelled_biases``, held to be ~0 on both sides).
      The encoder's gradients (FCRN's up-projections' too:
      ``BN_SPREAD_PREFIXES``) are
      compared by relative L2 norm, within 5e-2: in fp32 they are not fixed
      to 1e-3 by the inputs. A ReLU input within rounding of zero lands on
      the other side on the other device and takes its whole gradient with
      it; train-mode BN spreads that over the batch, and it reaches every
      encoder weight below it (PERF.md). The CPU's own fp32 step differs
      from its fp64 step in the same way.
    """
    from supervised_dispnet_tpu_torch.models import DispResNet, get_disp_net

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        B, H, W = MAIN_SHAPE
        rng = np.random.default_rng(2)
        depth = rng.uniform(1.0, 80.0, (B, H, W)) * (rng.uniform(size=(B, H, W)) < 0.1)
        batch = {"tgt": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
                 "intrinsics": np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)),
                 "depth": depth.astype(np.float16)}
        report = {}
        for label, kwargs, loss, plain_dev, other in checks:
            plain_dev = plain_dev or device
            net = kwargs.get("network")
            base = (get_disp_net(net, seed=3, device="cpu") if net else
                    DispResNet(**kwargs, generator=torch.Generator().manual_seed(3)))
            spread = BN_SPREAD_PREFIXES.get(net, ("encoder.",))
            l_a, g_a = _one_step(torch, copy.deepcopy(base).to(device), batch, device,
                                 loss=loss)
            l_b, g_b = _one_step(torch, copy.deepcopy(base).to(plain_dev), batch, plain_dev,
                                 plain=True, loss=loss)
            tag = f"{label} card vs {other}"
            # a BN-cancelled bias's gradient is held to be rounding (below
            # 1e-4 of its weight's) on both sides, not compared
            cancelled = bn_cancelled_biases(torch, base)
            for n, w in cancelled.items():
                if max(g_a[n].norm(), g_b[n].norm()) > 1e-4 * g_b[w].norm():
                    raise AssertionError(f"cross-check {tag}: {n}'s gradient is not ~0")
            g_a = {n: g for n, g in g_a.items() if n not in cancelled}
            g_b = {n: g for n, g in g_b.items() if n not in cancelled}
            strict = [n for n in g_b if plain_dev == device or not n.startswith(spread)]
            worst, bad = 0.0, []
            for n in strict:
                ok, excess = _grads_agree(g_a[n], g_b[n])
                worst = max(worst, excess)
                if not ok:
                    bad.append(f"{n} (excess {excess:.3g})")
            rels = sorted((_rel_l2(g_a[n], g_b[n]), n) for n in g_b if n not in strict)
            bad += [f"{n} (rel-L2 {r:.3g} > 5e-2)" for r, n in rels if r > 5e-2]
            rels = [r for r, _ in rels]
            if bad:
                raise AssertionError(f"cross-check {tag}: gradients disagree: "
                                     f"{', '.join(bad[:8])}{' ...' if len(bad) > 8 else ''}")
            if not math.isclose(l_a, l_b, rel_tol=1e-4):
                raise AssertionError(f"cross-check {tag}: loss {l_a} vs {l_b}")
            report[tag] = {"loss": [l_a, l_b], "rtol_1e-3_gradients": len(strict),
                           "bn_cancelled_biases": len(cancelled),
                           "worst_excess": worst,
                           "encoder_rel_l2_median": rels[len(rels) // 2] if rels else None,
                           "encoder_rel_l2_max": rels[-1] if rels else None}
            print(f"  cross-check {tag}: loss {l_a:.7g} / {l_b:.7g}; {len(strict)} "
                  f"gradients within rtol 1e-3 (worst excess {worst:.3g})"
                  + (f"; {len(cancelled)} BN-cancelled biases ~0" if cancelled else "")
                  + (f"; {len(rels)} encoder gradients (BN-spread) rel-L2 median "
                     f"{rels[len(rels) // 2]:.3g} max {rels[-1]:.3g}" if rels else ""),
                  flush=True)
        return report
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _one_selfsup_step(torch, disp, pose, batch: dict, device, plain: bool = False,
                      photo_phases=None, **step_kw):
    """One self-supervised train step (DispNetS + PoseExpNet), augmentation
    off, with the step builder's ``step_kw`` (a photometric arm) and the
    stochastic arm's ``photo_phases``; ``plain=True`` swaps the plain
    sampler in for the warp kernels. Returns ({loss, photo_loss, exp_loss,
    smooth_loss}, {name: grad on the CPU})."""
    from supervised_dispnet_tpu_torch.data.augment import AugmentConfig
    from supervised_dispnet_tpu_torch.ops import warp as wp
    from supervised_dispnet_tpu_torch.ops.sampling import bilinear_sample
    from supervised_dispnet_tpu_torch.training import train_step as ts

    no_aug = AugmentConfig(flip=False, scale_crop=False, color_jitter=False)
    opt = torch.optim.Adam(list(disp.parameters()) + list(pose.parameters()), lr=1e-4)
    step = ts.make_selfsup_train_step(disp, pose, opt, aug=no_aug, **step_kw)
    kernel_sample, kernel_many = wp.sample, wp.sample_many
    if plain:
        wp.sample = lambda i, x, y, mode, diff_img: bilinear_sample(
            i if diff_img else i.detach(), x, y, mode)
        wp.sample_many = lambda imgs, xs, ys, mode: [
            bilinear_sample(i.detach(), x, y, mode) for i, x, y in zip(imgs, xs, ys)]
    try:
        out = step({k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                   photo_phases=photo_phases)
    finally:
        wp.sample, wp.sample_many = kernel_sample, kernel_many
    grads = {f"{tag}.{n}": p.grad.detach().cpu()
             for tag, net in (("disp", disp), ("pose", pose))
             for n, p in net.named_parameters()}
    return {k: float(v) for k, v in out.items()}, grads


def _selfsup_check_inputs(torch) -> tuple[dict, tuple]:
    """The self-supervised cross-checks' batch at the main-path shape (uint8
    snippets, KITTI-like intrinsics) and seeded DispNetS + PoseExpNet (the
    init the CLI draws)."""
    from supervised_dispnet_tpu_torch.models import DispNetS, PoseExpNet

    B, H, W = MAIN_SHAPE
    rng = np.random.default_rng(6)
    batch = {"tgt": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
             "ref_imgs": rng.integers(0, 256, (B, 2, H, W, 3), dtype=np.uint8),
             "intrinsics": np.tile(np.array(KITTI_K, np.float32), (B, 1, 1))}
    return batch, (DispNetS(generator=torch.Generator().manual_seed(0)),
                   PoseExpNet(generator=torch.Generator().manual_seed(1)))


def selfsup_cross_check(torch, device: str = "cuda") -> dict:
    """One self-supervised train step at the main-path shape from identical
    weights (the seeded init the CLI draws) on one batch, augmentation off,
    TF32 off for cuDNN and matmul. The loss and its terms: rtol 1e-5 on the
    card, 1e-4 against the CPU. Each gradient tensor by relative L2 norm,
    within 1e-3.

    - Card with the warp kernels against the card with the plain sampler:
      the geometry runs the same code on the same device, so the warp's
      coordinates are bit-identical and only the order of the sampler's sums
      differs.
    - The kernel path against itself, run again: the noise floor. The step
      is not bit-reproducible on the card (the bilinear upsample's backward
      and cuDNN's weight gradients sum with atomics), and a few weight
      gradients whose terms cancel (DispNetS ``conv2.2``) differ from run to
      run by ~4e-4 relative L2, elementwise up to ~1e-3 of their largest
      entry; an elementwise rtol would measure that noise, not the kernels.
    - Card (kernels) against the CPU (plain sampler).
    """
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        batch, base = _selfsup_check_inputs(torch)

        def step(dev, plain):
            return _one_selfsup_step(torch, *(copy.deepcopy(m).to(dev) for m in base),
                                     batch, dev, plain=plain)

        l_a, g_a = step(device, False)
        report = {}
        for other, (dev, plain) in (("card kernels rerun", (device, False)),
                                    ("card plain", (device, True)),
                                    ("cpu", ("cpu", True))):
            l_b, g_b = step(dev, plain)
            tag = f"selfsup DispNetS + PoseExpNet card vs {other}"
            rtol = 1e-4 if dev == "cpu" else 1e-5
            bad = [k for k in l_a if not math.isclose(l_a[k], l_b[k], rel_tol=rtol)]
            if bad:
                raise AssertionError(f"cross-check {tag}: {bad} {l_a} vs {l_b}")
            rels = {n: _rel_l2(g_a[n], g_b[n]) for n in g_b}
            worst = max(rels, key=rels.get)
            report[tag] = {"loss": [l_a["loss"], l_b["loss"]], "terms": [l_a, l_b],
                           "rel_l2_median": sorted(rels.values())[len(rels) // 2],
                           "rel_l2_max": rels[worst], "rel_l2_worst": worst}
            print(f"  cross-check {tag}: loss {l_a['loss']:.7g} / {l_b['loss']:.7g} "
                  f"(photo {l_a['photo_loss']:.7g} / {l_b['photo_loss']:.7g}); "
                  f"{len(rels)} gradients rel-L2 median "
                  f"{report[tag]['rel_l2_median']:.3g} max {rels[worst]:.3g} ({worst})",
                  flush=True)
            if rels[worst] > 1e-3:
                raise AssertionError(f"cross-check {tag}: gradient {worst} rel-L2 "
                                     f"{rels[worst]:.3g} > 1e-3")
        return report
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


INT8_TOPS = 1979e12  # H100 SXM dense int8 tensor-core peak
CARD = "cuda"  # the int8 phase's device (a CPU rehearsal sets "cpu")
# the networks of the int8 phase: (network, fused decoder)
INT8_NETWORKS = (("disp_res_50", True), ("disp_res_50", False), ("dispnet", False),
                 ("disp_vgg_bn", True), ("fcrn", False))
INT8_BATCHES = (8, 64)
# the int8 conv of the kernels line: DispResNet-50's layer3 3x3 conv (256 ->
# 256 at stride 16) at B=8, the shape the issue names
INT8_LINE_CASE = ((8, 8, 26, 256), 3)


class Int8Call(NamedTuple):
    """One int8 conv call of a forward, as ``ops/quant.py`` made it: the
    tensors the kernel gets (x padded to the plan's channels, the weight
    packed for its phases) and the conv's true input channels ``cin``."""

    xq: Any
    w: Any
    geom: Any
    mult: Any
    bias: Any
    residual: Any
    kw: dict
    cin: int


def _int8_bound(torch, c: Int8Call, out) -> tuple[float, str]:
    """The conv's least time, from its own work: the input's true channels
    (not the plan's padding), each read once, the weight's true taps, the
    scales, the residual and the output written once at 3.35 TB/s, against
    the MACs of its taps (an lhs-dilated conv's dilation holes need none) at
    the int8 tensor-core peak."""
    B, H, W, _ = c.xq.shape
    cout = c.w.shape[0]
    k = c.geom.kh * c.geom.kw * c.cin
    n_bytes = (B * H * W * c.cin + cout * k + 8 * cout + out.numel() * out.element_size()
               + (0 if c.residual is None else c.residual.numel() * c.residual.element_size()))
    holes = c.geom.lhs_dilation[0] * c.geom.lhs_dilation[1]
    n_ops = 2.0 * out.shape[0] * out.shape[1] * out.shape[2] * cout * k / holes
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT8_TOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _record_int8_calls(torch, twin, x) -> list:
    """The int8 conv calls of one forward of ``twin`` (``Int8Call``s)."""
    from supervised_dispnet_tpu_torch.ops import quant as pq

    cins = {m.w.data_ptr(): m.cin for m in twin.modules() if isinstance(m, pq._QWeights)}
    calls, real = [], pq.int8_conv

    def record(xq, w, geom, mult, bias, residual=None, **kw):
        calls.append(Int8Call(xq, w, geom, mult, bias, residual, kw, cins[w.data_ptr()]))
        return real(xq, w, geom, mult, bias, residual=residual, **kw)

    pq.int8_conv = record
    try:
        with torch.inference_mode():
            twin(x)
    finally:
        pq.int8_conv = real
    return calls


def _same_conv_fp(torch, x_shape, cout, geom, dtype):
    """cuDNN's float conv of the int8 conv's shape (beside the kernel, timed
    only): NCHW ``dtype`` input (the true channels) and weight; an
    lhs-dilated conv as the transposed conv that computes it."""
    import torch.nn.functional as F

    B, H, W, C = x_shape
    x = torch.randn(B, C, H, W, device=CARD, dtype=dtype)
    pt, pb, pl, pr = geom.padding
    if geom.lhs_dilation != (1, 1):
        wt = torch.randn(C, cout, geom.kh, geom.kw, device=CARD, dtype=dtype)
        return lambda: F.conv_transpose2d(
            x, wt, stride=geom.lhs_dilation, padding=(geom.kh - 1 - pt, geom.kw - 1 - pl),
            output_padding=(pb - pt, pr - pl))
    wt = torch.randn(cout, C, geom.kh, geom.kw, device=CARD, dtype=dtype)
    return lambda: F.conv2d(x, wt, stride=geom.stride, padding=(pt, pl),
                            dilation=geom.rhs_dilation)


def call_device_us(torch, fn, reps: int = 5, tries: int = 3) -> float | None:
    """Device µs of one call of ``fn``: every device event of the call
    summed (``torch.profiler``, ``reps`` calls), profiled again up to
    ``tries`` times while it shows none (it can drop them); None (not
    measured) if it never does."""
    for _ in range(tries):
        us, n = device_us(torch, fn, [""], reps=reps)[""]
        if n > 0:
            return us * n
    return None


SPLIT_CHECK_K = 9216  # the deep-K convs: one of them is held without split-K too


def conv_key(c: Int8Call) -> tuple:
    """What makes an int8 conv distinct: shapes, geometry, epilogue."""
    variant = (c.kw.get("out", "f32"), c.kw.get("act", "none"),
               None if c.residual is None else str(c.residual.dtype))
    return tuple(c.xq.shape), c.cin, tuple(c.w.shape), c.geom, variant


def split_k_agrees(torch, c: Int8Call, acc, out) -> bool:
    """The conv launched with its plan's split-K (``acc``, ``out``) and in
    one K slice: the int32 accumulators and the outputs bit-equal."""
    from supervised_dispnet_tpu_torch.ops.cuda import int8_conv as ic

    kw = c.kw
    acc1 = ic.launch(c.xq, c.w, c.mult, c.bias, None, c.geom, 0, 3, 0, 0.0, 1.0, splits=1)
    out1 = ic.launch(c.xq, c.w, c.mult, c.bias, c.residual, c.geom,
                     ic.ACTS[kw.get("act", "none")], ic.OUTS[kw.get("out", "f32")],
                     ic._res_mode(c.residual, kw.get("res_before_bias", False)),
                     float(kw.get("res_scale", 0.0)), float(kw.get("out_scale", 1.0)),
                     splits=1)
    torch.cuda.synchronize()
    return torch.equal(acc1, acc) and torch.equal(out1, out)


def int8_conv_cases(torch, calls: list, card: str) -> list:
    """Each distinct conv of ``calls`` (``Int8Call``s: shape, geometry,
    epilogue) on the card: the kernel's int32 accumulators bit-equal to the
    plain reference's (``conv_acc_plain``: the zero-stuffed conv over the
    true channels, no phases), its output equal to the plain version's
    (ReLU, none, float outputs) or within one code (ELU); the first deep-K
    conv (K >= ``SPLIT_CHECK_K``) that the plan splits along K also
    bit-equal launched in one slice; then its time (CUDA events over 20
    calls, host included; device µs of a call: every device event of it,
    from the profiler), the plain version's, ``torch._int_mm`` over the
    im2col matrix's shape (K and N padded to multiples of 8; the im2col
    itself is not timed), cuDNN's fp32 (TF32 off) and bf16 conv of the
    shape, and the bound (``_int8_bound``)."""
    from supervised_dispnet_tpu_torch.ops.cuda import int8_conv as ic

    seen, rows, split_checked = set(), [], False
    for c in calls:
        key = conv_key(c)
        if key in seen:
            continue
        seen.add(key)
        xq, w, geom, mult, bias, residual, kw, cin = c
        variant = key[4]
        acc = ic.int8_conv(xq, w, geom, mult, bias, out="s32")
        acc_plain = ic.conv_acc_plain(xq[..., :cin].contiguous(), w, geom)
        out = ic.int8_conv(xq, w, geom, mult, bias, residual=residual, **kw)
        plain = ic.int8_conv_plain(xq, w, geom, mult, bias, residual=residual, **kw)
        torch.cuda.synchronize()
        if not torch.equal(acc, acc_plain):
            raise AssertionError(f"int8 conv {key}: accumulators differ from the plain "
                                 f"version by up to {int((acc - acc_plain).abs().max())}")
        err = float((out.float() - plain.float()).abs().max())
        codes = variant[0] == "s8"
        limit = 1.0 if codes and variant[1] == "elu" else 0.0
        if err > limit:
            raise AssertionError(f"int8 conv {key}: output off the plain version by {err}")
        k = geom.kh * geom.kw * cin
        pl = ic.plan(tuple(xq.shape), geom, w.shape[0])
        row = {"x": [*xq.shape[:3], cin], "cp": pl.cp, "cout": w.shape[0], "k": k,
               "geom": geom.as_list(), "out": variant[0], "act": variant[1],
               "residual": variant[2], "max_abs_err": err,
               "plan": {"bn": pl.bn, "bm": pl.bm, "splits": pl.splits,
                        "phases": len(pl.phases), "tiles": pl.tiles},
               "card": card}
        if pl.splits > 1 and k >= SPLIT_CHECK_K and not split_checked:
            if not split_k_agrees(torch, c, acc, out):
                raise AssertionError(f"int8 conv {key}: split-K ({pl.splits} slices) differs "
                                     "from one slice")
            row["split_k_equal_one_slice"] = split_checked = True
        row["bound_ms"], row["bound_by"] = _int8_bound(torch, c, out)

        def fn(xq=xq, w=w, geom=geom, mult=mult, bias=bias, residual=residual, kw=kw):
            return ic.int8_conv(xq, w, geom, mult, bias, residual=residual, **kw)

        row["ms"] = cuda_ms(torch, fn, reps=20, warmup=3)
        row["device_us"] = call_device_us(torch, fn)
        row["plain_ms"] = cuda_ms(torch, lambda: ic.int8_conv_plain(
            xq, w, geom, mult, bias, residual=residual, **kw), reps=3, warmup=1)
        M = out.shape[0] * out.shape[1] * out.shape[2]
        a = torch.randint(-127, 128, (max(M, 17), -(-k // 8) * 8), device=CARD,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (-(-w.shape[0] // 8) * 8, a.shape[1]),
                          device=CARD, dtype=torch.int8).t()
        row["library_ms"] = cuda_ms(torch, lambda: torch._int_mm(a, b), reps=20, warmup=3)
        for dt, name in ((torch.float32, "cudnn_fp32_ms"), (torch.bfloat16, "cudnn_bf16_ms")):
            row[name] = cuda_ms(torch, _same_conv_fp(torch, row["x"], w.shape[0], geom, dt),
                                reps=20, warmup=3)
        rows.append(row)
    if not split_checked:
        raise AssertionError("no deep-K conv that the plan splits along K was held in one "
                             "slice")
    return rows


def _bn_to_batch(torch, model, x) -> None:
    """Set every BatchNorm's running statistics to those of batch ``x`` (a
    train-mode forward with momentum 1), as a trained model's describe its
    data: with the init's statistics a random ResNet-50's activations reach
    ~1e4 and its int8 forward says nothing of a trained one
    (``tests/torch_quant_ref.py`` does the same through JAX)."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(x)
    model.eval()
    for m in bns:
        m.momentum = 0.1


def _int8_model(torch, network: str, fused: bool, ckpt: str | None):
    from supervised_dispnet_tpu_torch.cli.test_disp import load_model
    from supervised_dispnet_tpu_torch.models import get_disp_net

    if ckpt is not None and network == "disp_res_50":
        return load_model(ckpt, network, fused_upsample=fused, device=CARD)
    return get_disp_net(network, fused_upsample=fused, seed=13, device=CARD).eval()


def int8_forced_cpu(torch, twin, cpu_twin, x):
    """The CPU twin's forward of ``x`` with each int8 conv given the card
    twin's int8 input and residual for that call (the card's calls, in
    order), so that a code that a float op's rounding moved on one device
    does not spread; returns (that forward's output, for each call the int8
    input's elements that differ from the CPU's own and the largest
    difference, and the residual's largest relative difference)."""
    from supervised_dispnet_tpu_torch.ops import quant as pq

    card = _record_int8_calls(torch, twin, x)
    parts, real = [], pq.int8_conv

    def forced(xq, w, geom, mult, bias, residual=None, **kw):
        c = card[len(parts)]
        xc = c.xq.cpu()
        d = (xq.int() - xc.int()).abs()
        part = {"differ": int((d > 0).sum()), "max": int(d.max()), "of": d.numel()}
        rc = None
        if residual is not None:
            rc = c.residual.cpu()
            rd = (residual.float() - rc.float()).abs() / rc.float().abs().clamp_min(1e-6)
            part["residual_max_rel"] = float(rd.max())
        parts.append(part)
        return real(xc, w, geom, mult, bias, residual=rc, **kw)

    pq.int8_conv = forced
    try:
        with torch.inference_mode():
            out = cpu_twin(x.cpu())
    finally:
        pq.int8_conv = real
    if len(parts) != len(card):
        raise AssertionError(f"the CPU twin ran {len(parts)} int8 convs, the card's {len(card)}")
    return out, parts


def int8_parting(torch, twin, cpu_twin, x) -> dict:
    """Where the card's and the CPU's int8 twins part on ``x``: whether every
    int8 conv the card ran equals the plain version on its own inputs, and
    the first call whose int8 input or residual differs between the two
    devices (index, elements that differ, the largest difference)."""
    from supervised_dispnet_tpu_torch.ops import quant as pq
    from supervised_dispnet_tpu_torch.ops.cuda import int8_conv as ic

    card = _record_int8_calls(torch, twin, x)
    cpu, real = [], pq.int8_conv

    def record(xq, w, geom, mult, bias, residual=None, **kw):
        cpu.append((xq, residual))
        return real(xq, w, geom, mult, bias, residual=residual, **kw)

    pq.int8_conv = record
    try:
        with torch.inference_mode():
            cpu_twin(x.cpu())
    finally:
        pq.int8_conv = real
    exact, first = True, None
    for i, (c, (xq, r)) in enumerate(zip(card, cpu)):
        with torch.inference_mode():
            y = ic.int8_conv(c.xq, c.w, c.geom, c.mult, c.bias, residual=c.residual, **c.kw)
            want = ic.int8_conv_plain(c.xq, c.w, c.geom, c.mult, c.bias, residual=c.residual,
                                      **c.kw)
        exact &= torch.equal(y, want)
        if first is None:
            for name, a, b in (("x", c.xq, xq), ("residual", c.residual, r)):
                if a is not None and not torch.equal(a.cpu(), b):
                    d = (a.cpu().float() - b.float()).abs()
                    first = {"call": i, "tensor": name, "differ": int((d > 0).sum()),
                             "of": d.numel(), "max": float(d.max())}
                    break
    return {"calls": len(card), "kernel_equals_plain": exact, "first_part": first}


def forward_device_us(torch, fwd, reps: int = 3) -> dict:
    """Device µs of one forward: its int8 conv kernels' summed, their
    launches, and every device event's summed (``torch.profiler``)."""
    got = device_us(torch, fwd, ["int8_conv_kernel", ""], reps=reps)
    (conv_us, n), (all_us, n_all) = got["int8_conv_kernel"], got[""]
    return {"int8_conv_us": conv_us * n, "int8_conv_launches": n, "all_us": all_us * n_all}


def int8_networks_phase(torch, card: str, ckpt: str | None) -> tuple[dict, list]:
    """``quantized_apply``'s int8 twin of each network of ``INT8_NETWORKS``
    at 128x416, its BN statistics those of 8 normalised random frames
    (``_bn_to_batch``), calibrated on them: its int8 conv
    launches a forward at B=8 (one a quantized conv: ``n_int8_convs``),
    the finest output against the CPU twin's (same weights and ranges, B=1;
    FCRN's depth with a floor of 1e-3 of its largest). The int8 convs agree
    bit for bit (``int8_conv_cases``), but the float ops between them
    (bilinear resizes, the per-conv path's BN, the fused stage's border
    corrections, the bf16 heads) round otherwise on the two devices, and a
    value within an ulp of a rounding half moves its code by one, which a
    briefly trained net spreads from a low-resolution stage to a share of
    its pixels (seen: p99 4.9% and 24% of the pixels above 1e-3 on the
    unfused DispResNet-50, 2.9% on the fused one, where the border
    corrections' float32 residual moved codes; the tree with the earlier
    one-phase ``mma.sync`` kernel gives the same numbers on the same
    checkpoint, ``scripts/int8_card_vs_cpu.py``). So
    the output is held end to end against the CPU twin to its median rel <=
    1e-3 and finiteness (its 99th percentile and largest are reported), and
    against the CPU twin fed, at each int8 conv, the card's int8 input and
    residual (``int8_forced_cpu``): median rel <= 1e-3, 99th percentile <=
    2e-2, the CPU tests' limits, max <= 0.25; and each such input's codes
    within one of the CPU's own, on at most 1e-3 of its elements. FCRN's float
    BNs between its int8 convs carry a moved code through four
    up-projections to a ReLU'd depth: its output held to its median and
    finiteness alone, as JAX holds a random-init FCRN's int8 forward (seen:
    p99 1e-6 to 1.4e-2, one pixel 0.89). img/s at
    B=8 and 64 (CUDA
    events) beside the float32 forward (TF32 off) and, for the networks with
    a bf16 trunk, the bf16 one; the int8 forward's device µs at each batch
    (``forward_device_us``); peak memory of a forward at B=64 beside
    fp32's (above what the card held before it). Returns
    (results, the int8 conv calls of DispResNet-50 fused and unfused, FCRN's
    unpool convs and DispNetS's ragged-channel ones)."""
    from supervised_dispnet_tpu_torch.models.common import set_compute_dtype
    from supervised_dispnet_tpu_torch.ops import quant as pq
    from supervised_dispnet_tpu_torch.ops.cuda import int8_conv as ic
    from supervised_dispnet_tpu_torch.utils.device import set_fp32_math

    set_fp32_math()
    _, H, W = MAIN_SHAPE
    gen = torch.Generator().manual_seed(21)
    frames = {b: (torch.rand(b, H, W, 3, generator=gen) * 2 - 1).to(CARD)
              for b in INT8_BATCHES}
    out, calls = {}, []
    top = INT8_BATCHES[-1]
    for network, fused in INT8_NETWORKS:
        label = f"{network}{'-fused' if fused else ''}"
        model = _int8_model(torch, network, fused, ckpt)
        _bn_to_batch(torch, model, frames[8])
        ranges = pq.calibrate_conv_ranges(model, [frames[8]], percentile=99.9)
        twin = pq.QuantizedModel(model, ranges).to(CARD)
        ic.reset_counts()
        with torch.inference_mode():
            twin(frames[8])
        torch.cuda.synchronize()
        if ic.int8_conv_launches != twin.n_int8_convs or not twin.n_int8_convs:
            raise AssertionError(f"int8 {label}: {ic.int8_conv_launches} int8 conv launches "
                                 f"a forward, {twin.n_int8_convs} quantized convs")
        res = {"int8_convs": twin.n_int8_convs, "launches": ic.int8_conv_launches,
               "variants": dict(ic.int8_conv_variants), "encoder_chain": twin.encoder_chain,
               "decoder_chain": twin.dec_chain, "card": card}
        mine = _record_int8_calls(torch, twin, frames[8])
        if network == "disp_res_50":
            calls += mine
        elif network == "fcrn":
            calls += [c for c in mine if c.geom.lhs_dilation == (2, 2)]
        elif network == "dispnet":
            calls += [c for c in mine if c.cin % 4]
        # the card against the CPU: the same twin's weights and ranges, B=1
        cpu_twin = pq.QuantizedModel(copy.deepcopy(model).cpu(), ranges)
        with torch.inference_mode():
            got = twin(frames[8][:1])
            want = cpu_twin(frames[8][:1].cpu())
        forced, parts = int8_forced_cpu(torch, twin, cpu_twin, frames[8][:1])
        g = (got[0] if isinstance(got, list) else got).float().cpu().numpy()
        for key, ref in (("card_vs_cpu", want), ("card_vs_cpu_forced", forced)):
            wt = (ref[0] if isinstance(ref, list) else ref).float().numpy()
            floor = 1e-3 * np.abs(wt).max() if network == "fcrn" else 1e-6
            rel = np.abs(g - wt) / np.maximum(np.abs(wt), floor)
            res[key] = {"median_rel": float(np.median(rel)),
                        "p99_rel": float(np.percentile(rel, 99)),
                        "max_rel": float(rel.max()),
                        "share_above_1e-3": float((rel > 1e-3).mean())}
        moved = {"codes": sum(p["differ"] for p in parts),
                 "largest": max(p["max"] for p in parts),
                 "largest_share": max(p["differ"] / p["of"] for p in parts)}
        res["card_vs_cpu_forced"]["moved"] = moved
        fc, uf = res["card_vs_cpu_forced"], res["card_vs_cpu"]
        tails = network == "fcrn" or (fc["p99_rel"] <= 2e-2 and fc["max_rel"] <= 0.25)
        if not (np.isfinite(g).all() and uf["median_rel"] <= 1e-3 and fc["median_rel"] <= 1e-3
                and tails and moved["largest"] <= 1 and moved["largest_share"] <= 1e-3):
            res["card_vs_cpu"]["parting"] = int8_parting(torch, twin, cpu_twin, frames[8][:1])
            raise AssertionError(f"int8 {label}: card vs CPU {res['card_vs_cpu']}, fed the "
                                 f"card's int8 inputs {fc}")
        bf16 = None
        if getattr(model, "has_compute_dtype", False):
            bf16 = copy.deepcopy(model)
            set_compute_dtype(bf16, torch.bfloat16)
        for b in INT8_BATCHES:
            x = frames[b]
            for name, net in (("int8", twin), ("fp32", model), ("bf16", bf16)):
                if net is None:
                    continue

                def fwd(net=net):
                    with torch.inference_mode():
                        return net(x)

                ms = cuda_ms(torch, fwd, reps=10 if b == top else 20, warmup=2)
                res[f"{name}_b{b}_img_s"] = b / ms * 1e3
                if name == "int8":
                    res[f"device_us_b{b}"] = forward_device_us(torch, fwd)
                if b == top:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    fwd()
                    torch.cuda.synchronize()
                    res[f"{name}_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        print(f"  int8 {label}: {res['int8_convs']} int8 convs a forward (launches "
              f"{res['launches']}; chains: encoder {res['encoder_chain']}, decoder "
              f"{res['decoder_chain']}); card vs CPU median rel "
              f"{res['card_vs_cpu']['median_rel']:.3g}, p99 {res['card_vs_cpu']['p99_rel']:.3g}, "
              f"max {res['card_vs_cpu']['max_rel']:.3g}, share above 1e-3 "
              f"{res['card_vs_cpu']['share_above_1e-3']:.3g}; fed the card's int8 inputs "
              f"p99 {fc['p99_rel']:.3g}, max {fc['max_rel']:.3g}, codes moved "
              f"{moved['codes']}; "
              + "; ".join(f"B={b} img/s int8 {res[f'int8_b{b}_img_s']:.1f} fp32 "
                          f"{res[f'fp32_b{b}_img_s']:.1f}"
                          + (f" bf16 {res[f'bf16_b{b}_img_s']:.1f}" if bf16 is not None else "")
                          for b in INT8_BATCHES)
              + f"; B={top} peak MiB int8 {res['int8_peak_mib']:.0f} fp32 "
              f"{res['fp32_peak_mib']:.0f}; on {card}", flush=True)
        print(f"  int8 {label} forward's device µs: " + "; ".join(
            f"B={b} int8 convs {d['int8_conv_us']:.1f} ({d['int8_conv_launches']:g} launches), "
            f"all device events {d['all_us']:.1f}"
            for b in INT8_BATCHES for d in [res[f"device_us_b{b}"]]) + f"; on {card}",
              flush=True)
        out[label] = res
        del twin, cpu_twin, bf16, model
        torch.cuda.empty_cache()
    return out, calls


def int8_serving_phase(torch, tmp: Path, card: str, ckpt: str, tree: Path) -> dict:
    """``DepthService(int8=True)`` from the BerHu run's DispResNet-50
    checkpoint, fused, calibrated on the tree's first 8 frames (area-resized
    as requests are), beside the fp32 service: p50 latency at one request in
    flight (bucket 1) and img/s of ``predict`` at buckets 8 and 64 (host
    clock around the call, readback included); int8 against fp32 depth."""
    from supervised_dispnet_tpu_torch.data.image_resize import resize_area_uint8
    from supervised_dispnet_tpu_torch.kitti_eval.synthetic import DATE
    from supervised_dispnet_tpu_torch.ops.cuda import int8_conv as ic
    from supervised_dispnet_tpu_torch.serving import DepthService, ServingConfig
    from supervised_dispnet_tpu_torch.utils.image_io import read_image

    _, H, W = MAIN_SHAPE
    frames = sorted((tree.parent / DATE / f"{DATE}_drive_0001_sync" / "image_02" /
                     "data").glob("*.png"))[:8]
    calib = [resize_area_uint8(read_image(f), H, W) for f in frames]
    out = {"card": card}
    imgs = np.random.default_rng(16).integers(0, 256, (64, H, W, 3), dtype=np.uint8)
    preds = {}
    for name, int8 in (("int8", True), ("fp32", False)):
        svc = DepthService.from_checkpoint(ckpt, "disp_res_50", ServingConfig(
            img_height=H, img_width=W, int8=int8), calibration=calib if int8 else None)
        svc.warmup()
        ic.reset_counts()
        res = {"latency_b1": _serve_latency(svc, calib, n=40)}
        for b in (8, 64):
            svc.predict(imgs[:b])
            t0 = time.perf_counter()
            for _ in range(5):
                svc.predict(imgs[:b])
            res[f"b{b}_img_s"] = 5 * b / (time.perf_counter() - t0)
        res["int8_conv_launches"] = ic.int8_conv_launches
        if (ic.int8_conv_launches > 0) != int8:
            raise AssertionError(f"serving {name}: {ic.int8_conv_launches} int8 conv launches")
        preds[name] = svc.predict(imgs[:8])
        out[name] = res
        print(f"  int8 serving {name}: p50 {res['latency_b1']['p50_ms']:.2f} ms at bucket 1; "
              f"predict {res['b8_img_s']:.1f} img/s at 8, {res['b64_img_s']:.1f} at 64; "
              f"int8 conv launches {res['int8_conv_launches']}; on {card}", flush=True)
    rel = np.abs(preds["int8"] - preds["fp32"]) / np.abs(preds["fp32"])
    out["int8_vs_fp32"] = {"median_rel": float(np.median(rel)), "max_rel": float(rel.max())}
    if not np.isfinite(preds["int8"]).all():
        raise AssertionError("int8 serving: depth not finite")
    print(f"  int8 serving: depth against fp32 median rel {np.median(rel):.4g}", flush=True)
    return out


def int8_train_phase(torch, tmp: Path, card: str) -> dict:
    """``cli/train.py --qat``, 3 steps each: DispResNet-50 BerHu (1 + 1
    grouped BerHu launches a step, as without --qat) and DispNetS +
    PoseExpNet self-supervised (1 + 1 grouped warp launches a step, 1
    forward a validation batch), at 128x416, B=4; then one fake-quant step
    of DispResNet-18 card against CPU from the same weights and batch: the
    loss within rel 1e-3 (the QDQ rounds values the two devices compute to
    fp32 rounding; the gradients under fake quant are not fixed by the
    inputs at that rounding, ``tests/test_torch_qat.py``, so they are held
    by their norms, ratio 0.5..2)."""
    from supervised_dispnet_tpu_torch.cli import train as train_cli
    from supervised_dispnet_tpu_torch.models import DispResNet
    from supervised_dispnet_tpu_torch.ops.cuda import losses as kl
    from supervised_dispnet_tpu_torch.ops.cuda import warp as kw
    from supervised_dispnet_tpu_torch.training.train_step import make_supervised_train_step
    from supervised_dispnet_tpu_torch.training.trainer import TrainerConfig, build_optimizer

    B, H, W = MAIN_SHAPE
    out = {"card": card}
    write_packed(tmp / "sup", np.random.default_rng(31), H, W)
    write_packed(tmp / "ss", np.random.default_rng(32), H, W, with_depth=False)
    kl.berhu_fwd_launches = kl.berhu_bwd_launches = kl.berhu_fwd_problems = 0
    with contextlib.redirect_stdout(_Tee(sys.stdout)):
        t = train_cli.main([str(tmp / "sup"), "--network", "disp_res_50", "--loss", "berhu",
                            "-b", str(B), "--epoch-size", "3", "--epochs", "1", "--qat",
                            "--checkpoints-dir", str(tmp / "ck"), "--name", "qat"])
    torch.cuda.synchronize()
    got = (kl.berhu_fwd_launches, kl.berhu_bwd_launches, kl.berhu_fwd_problems)
    if t.step != 3 or got != (3, 3, 12):
        raise AssertionError(f"--qat BerHu: {t.step} steps, launches {got} (want 3, 3, 12)")
    out["supervised"] = {"steps": t.step, "berhu_launches": got}
    for attr in ("warp_fwd_launches", "warp_bwd_launches", "warp_bwd_coords_launches"):
        setattr(kw, attr, 0)
    with contextlib.redirect_stdout(_Tee(sys.stdout)):
        t = train_cli.main([str(tmp / "ss"), "--network", "dispnet", "--loss", "selfsup",
                            "--sequence-length", "3", "-b", str(B), "--epoch-size", "3",
                            "--epochs", "1", "--qat", "--checkpoints-dir", str(tmp / "ck"),
                            "--name", "qat_ss"])
    torch.cuda.synchronize()
    val_batches = len(t.make_loaders()[1])
    got = (kw.warp_fwd_launches, kw.warp_bwd_launches, kw.warp_bwd_coords_launches)
    if t.step != 3 or got != (3 + val_batches, 0, 3):
        raise AssertionError(f"--qat selfsup: {t.step} steps, warp launches {got}")
    out["selfsup"] = {"steps": t.step, "warp_launches": got}

    gen = torch.Generator().manual_seed(33)
    net = DispResNet(18, generator=gen)
    rng = np.random.default_rng(34)
    batch = {"tgt": rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8),
             "intrinsics": np.tile(np.array(KITTI_K, np.float32), (2, 1, 1)),
             "depth": (rng.uniform(1, 80, (2, H, W)) * (rng.uniform(size=(2, H, W)) < 0.1)
                       ).astype(np.float32)}
    from supervised_dispnet_tpu_torch.data.augment import AugmentConfig

    no_aug = AugmentConfig(flip=False, scale_crop=False, color_jitter=False)
    res = {}
    for dev in (CARD, "cpu"):
        m = copy.deepcopy(net).to(dev)
        opt = build_optimizer(TrainerConfig(), m.parameters())
        step = make_supervised_train_step(m, opt, "berhu", aug=no_aug, fake_quant=True)
        loss = step({k: torch.from_numpy(v).to(dev) for k, v in batch.items()})["loss"]
        res[dev] = (float(loss), {n: float(p.grad.norm()) for n, p in m.named_parameters()})
    card_res, cpu_res = res[CARD], res["cpu"]
    loss_rel = abs(card_res[0] - cpu_res[0]) / abs(cpu_res[0])
    ratios = [card_res[1][n] / max(v, 1e-30) for n, v in cpu_res[1].items() if v > 0]
    out["card_vs_cpu"] = {"loss_rel": loss_rel, "grad_norm_ratio": [min(ratios), max(ratios)]}
    print(f"  --qat: BerHu {out['supervised']['berhu_launches']}, selfsup warp "
          f"{out['selfsup']['warp_launches']} launches over 3 steps; fake-quant step card vs "
          f"CPU loss rel {loss_rel:.3g}, gradient norm ratios {min(ratios):.3f}.."
          f"{max(ratios):.3f}", flush=True)
    if loss_rel > 1e-3 or min(ratios) < 0.5 or max(ratios) > 2.0:
        raise AssertionError(f"--qat step card vs CPU: {out['card_vs_cpu']}")
    return out


def int8_export_phase(torch, tmp: Path, card: str, ckpt: str) -> dict:
    """The int8 twin of the BerHu run's DispResNet-50 (fused) exported with
    a dynamic batch, then loaded and run on the card in a fresh process that
    imports only the int8 op's module (and turns TF32 off, as the port's
    entry points and ``load_forward`` do): its depth equal to the live
    twin's bit for bit, at B=8 and 3; the int8 program's size beside the
    fp32 one's."""
    from supervised_dispnet_tpu_torch.cli.test_disp import load_model
    from supervised_dispnet_tpu_torch.ops import quant as pq
    from supervised_dispnet_tpu_torch.utils import export as ex

    _, H, W = MAIN_SHAPE
    model = load_model(ckpt, "disp_res_50", fused_upsample=True, device=CARD)
    x = (torch.rand(8, H, W, 3, generator=torch.Generator().manual_seed(35)) * 2 - 1).to(CARD)
    ranges = pq.calibrate_conv_ranges(model, [x])
    t0 = time.perf_counter()
    ex.export_forward(model, tmp / "q.pt2", batch_size="dynamic", img_height=H, img_width=W,
                      int8_ranges=ranges)
    ex.export_forward(model, tmp / "fp.pt2", batch_size="dynamic", img_height=H, img_width=W)
    export_s = time.perf_counter() - t0
    with torch.inference_mode():
        twin = pq.QuantizedModel(model, ranges).to(CARD)
        np.save(tmp / "want8.npy", twin(x)[0].cpu().numpy())
        np.save(tmp / "want3.npy", twin(x[:3])[0].cpu().numpy())
    np.save(tmp / "x.npy", x.cpu().numpy())
    code = (
        "import sys, numpy as np, torch\n"
        "import supervised_dispnet_tpu_torch.ops.cuda.int8_conv as ic\n"
        "torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False\n"
        f"f = torch.export.load({str(tmp / 'q.pt2')!r}).module()\n"
        f"x = torch.from_numpy(np.load({str(tmp / 'x.npy')!r})).to({CARD!r})\n"
        "with torch.no_grad():\n"
        "    y8, y3 = f(x).cpu().numpy(), f(x[:3]).cpu().numpy()\n"
        f"assert np.array_equal(y8, np.load({str(tmp / 'want8.npy')!r}))\n"
        f"assert np.array_equal(y3, np.load({str(tmp / 'want3.npy')!r}))\n"
        "assert (ic.int8_conv_launches > 0) == x.is_cuda and 'jax' not in sys.modules\n"
        "assert 'supervised_dispnet_tpu_torch.ops.quant' not in sys.modules\n"
        "print('launches', ic.int8_conv_launches)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"int8 export round trip failed:\n{r.stdout}\n{r.stderr[-4000:]}")
    res = {"export_s": export_s, "int8_mib": (tmp / "q.pt2").stat().st_size / 2**20,
           "fp32_mib": (tmp / "fp.pt2").stat().st_size / 2**20,
           "subprocess": r.stdout.strip(), "card": card}
    print(f"  int8 export: {res['int8_mib']:.1f} MiB (fp32 {res['fp32_mib']:.1f}); a fresh "
          f"process ran it bit for bit ({res['subprocess']})", flush=True)
    if res["int8_mib"] >= res["fp32_mib"]:
        raise AssertionError(f"the int8 program is not smaller: {res}")
    return res


# convs the networks do not run, each a path of the kernel's: (x shape,
# Cout, geometry, epilogue, residual dtype); the plain version holds them
INT8_EDGE_CASES = (
    ((2, 9, 11, 24), 21, (3, 3, (1, 1), (1, 1, 1, 1)), {"act": "relu", "out": "s8"}, None),
    ((2, 9, 11, 24), 21, (3, 3, (1, 1), (1, 1, 1, 1)), {"act": "relu", "out": "s8",
                                                        "res_scale": 0.02}, "int8"),
    ((2, 9, 11, 5), 40, (3, 3, (1, 1), (2, 1, 0, 2), (1, 1), (2, 2)), {"out": "bf16"}, None),
    ((2, 9, 11, 48), 300, (4, 2, (1, 1), (3, 0, 1, 2), (2, 2)), {"act": "elu", "out": "s8"},
     "float32"),
    ((1, 3, 5, 40), 21, (1, 1, (1, 1), (0, 1, 0, 1), (2, 2)), {"out": "f32"}, None),
    ((3, 17, 19, 130), 70, (3, 3, (2, 2), (1, 1, 1, 1)), {"act": "relu", "out": "bf16"},
     "bfloat16"),
    ((1, 4, 13, 4096), 96, (3, 3, (1, 1), (1, 1, 1, 1)), {"act": "elu", "out": "f32"}, None),
)


def int8_call_host_us(torch, c: Int8Call) -> dict:
    """Host µs of one int8 conv call (``host_us``): ``int8_conv`` as the
    int8 twins call it (eagerly: the kernel's launch, checks included) and
    through ``torch.ops.sdtpu.int8_conv``, the custom op an exported
    program calls."""
    from supervised_dispnet_tpu_torch.ops.cuda import int8_conv as ic

    kw = c.kw
    args = (c.xq, c.w, c.mult, c.bias, c.residual, c.geom.as_list(),
            ic.ACTS[kw.get("act", "none")], ic.OUTS[kw.get("out", "f32")],
            ic._res_mode(c.residual, kw.get("res_before_bias", False)),
            float(kw.get("res_scale", 0.0)), float(kw.get("out_scale", 1.0)))
    return {"int8_conv": host_us(torch, lambda: ic.int8_conv(c.xq, c.w, c.geom, c.mult, c.bias,
                                                             residual=c.residual, **kw)),
            "custom_op": host_us(torch, lambda: torch.ops.sdtpu.int8_conv(*args))}


def int8_edge_cases(torch, card: str) -> dict:
    """``INT8_EDGE_CASES`` on the card: odd and ragged Cout (scalar stores
    and partial tiles), a C that the wrapper pads, rhs dilation with uneven
    padding, a phase without taps, a stride-2 conv, a deep K split across
    blocks; each int32 accumulator bit-equal to ``conv_acc_plain`` and each
    output to the plain version's (ELU within one code)."""
    from supervised_dispnet_tpu_torch.ops.cuda import int8_conv as ic

    g = torch.Generator(device=CARD).manual_seed(41)
    out = []
    for shape, cout, geo, kw, res in INT8_EDGE_CASES:
        geom = ic.Geometry(*geo)
        x = torch.randint(-127, 128, shape, device=CARD, generator=g, dtype=torch.int8)
        wq = torch.randint(-127, 128, (cout, geom.kh, geom.kw, shape[3]), device=CARD,
                           generator=g, dtype=torch.int8)
        w = ic.pack_weight(wq, geom)
        mult = torch.rand(cout, device=CARD, generator=g) * 2e-5
        bias = torch.randn(cout, device=CARD, generator=g) * 0.3
        ho, wo = geom.out_hw(shape[1], shape[2])
        r = None
        if res == "int8":
            r = torch.randint(-127, 128, (shape[0], ho, wo, cout), device=CARD, generator=g,
                              dtype=torch.int8)
        elif res is not None:
            r = torch.randn(shape[0], ho, wo, cout, device=CARD, generator=g).to(
                getattr(torch, res))
        kw = {**kw, "out_scale": 0.05, "res_before_bias": res == "float32"}
        acc = ic.int8_conv(x, w, geom, mult, bias, out="s32")
        y = ic.int8_conv(x, w, geom, mult, bias, residual=r, **kw)
        want = ic.int8_conv_plain(x, w, geom, mult, bias, residual=r, **kw)
        torch.cuda.synchronize()
        err = float((y.float() - want.float()).abs().max())
        pl = ic.plan(tuple(x.shape), geom, cout)
        row = {"x": list(shape), "cout": cout, "geom": geom.as_list(), "splits": pl.splits,
               "acc_equal": torch.equal(acc, ic.conv_acc_plain(x, w, geom)), "max_abs_err": err}
        out.append(row)
        limit = 1.0 if kw.get("act") == "elu" and kw["out"] == "s8" else 0.0
        if not row["acc_equal"] or not err <= limit:
            raise AssertionError(f"int8 conv edge case {row} off the plain version")
    print(f"  int8 conv edge cases: {len(out)} bit-equal to the plain version (K slices "
          f"{[r['splits'] for r in out]}); on {card}", flush=True)
    return {"cases": out, "card": card}


# ResNet-50's layer2_0 conv2 at B=1 (3x3 stride 2, 128 -> 128 channels on
# 32x104): 13 output tiles, 2 K slices, a workspace under 1 MiB
INT8_FRESH_STREAM_CASE = ((1, 32, 104, 128), 128, (3, 3, (2, 2), (1, 1, 1, 1)))


def int8_split_fresh_stream(torch, card: str) -> dict:
    """``INT8_FRESH_STREAM_CASE`` launched twice on a new stream: the first
    split-K launch there allocates its arrival counters (16 KiB) beside a
    workspace of the caching allocator's small pool (under 1 MiB), so a
    workspace freed before the launch would be handed out as the counters.
    Both launches' int32 accumulators bit-equal to ``conv_acc_plain``, and
    the counters back at 0 after them."""
    from supervised_dispnet_tpu_torch.ops.cuda import int8_conv as ic

    shape, cout, geo = INT8_FRESH_STREAM_CASE
    geom = ic.Geometry(*geo)
    g = torch.Generator(device=CARD).manual_seed(43)
    x = torch.randint(-127, 128, shape, device=CARD, generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, geom.kh, geom.kw, shape[3]), device=CARD,
                       generator=g, dtype=torch.int8)
    w = ic.pack_weight(wq, geom)
    mult = torch.ones(cout, device=CARD)
    bias = torch.zeros(cout, device=CARD)
    pl = ic.plan(shape, geom, cout)
    ws_bytes = pl.tiles * pl.splits * pl.bm * pl.bn * 4
    if pl.splits < 2 or ws_bytes >= 2**20:
        raise AssertionError(f"int8 fresh-stream case: {pl.splits} K slices, workspace "
                             f"{ws_bytes} B; wants a split with a workspace under 1 MiB")
    want = ic.conv_acc_plain(x, w, geom)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        got = [ic.int8_conv(x, w, geom, mult, bias, out="s32") for _ in range(2)]
    stream.synchronize()
    counters = ic._counters[(x.device.index, stream.cuda_stream)]
    row = {"x": list(shape), "cout": cout, "splits": pl.splits, "workspace_bytes": ws_bytes,
           "acc_equal": [torch.equal(a, want) for a in got],
           "counters_zero": not bool(counters.any()), "card": card}
    if not all(row["acc_equal"]) or not row["counters_zero"]:
        raise AssertionError(f"int8 conv: split-K on a new stream off the plain version: {row}")
    print(f"  int8 conv split-K on a new stream (x{list(shape)}, {pl.splits} K slices, "
          f"workspace {ws_bytes} B): two launches bit-equal to the plain version, counters "
          f"back at 0; on {card}", flush=True)
    return row


def int8_sass() -> dict:
    """The built int8 conv's tensor-core instructions, from ``cuobjdump
    -sass`` beside ``nvcc`` (Hopper's wgmma shows as IGMMA for int8): their
    count and shapes; None where the toolkit has no cuobjdump."""
    from supervised_dispnet_tpu_torch.ops.cuda import _build

    tool = shutil.which("cuobjdump") or str(Path(_build.find_nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        return {"igmma": None}
    sass = subprocess.run([tool, "-sass", str(_build.library_path("int8_conv"))],
                          capture_output=True, text=True, check=True).stdout
    ops = re.findall(r"\b([A-Z]*GMMA\.[\w.]+)", sass)
    return {"igmma": len(ops), "shapes": sorted(set(ops)),
            "mma_sync": len(re.findall(r"\bIMMA\.", sass))}


def int8_phase(torch, tmp: Path, card: str, ckpt: str, tree: Path) -> tuple[dict, dict]:
    """int8 serving on the card (A5): the int8 conv's build holds wgmma
    (``int8_sass``); the networks' int8 twins (img/s, device µs a
    forward); every conv shape of DispResNet-50 (chains and fused decoder)
    at (8, 3, 128, 416), FCRN's unpool convs and DispNetS's ragged ones
    against the plain version and timed, one deep K also in one K slice;
    the kernel's other paths (``INT8_EDGE_CASES``); a call's host µs; the
    int8 service, the eval CLI with ``--int8`` beside fp32, ``--qat``
    training and an int8 export round trip. Returns (its results, the int8
    conv's kernels-line entry)."""
    tmp.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    sass = int8_sass()
    print(f"  int8 conv SASS: {sass}", flush=True)
    if sass["igmma"] == 0:
        raise AssertionError(f"the int8 conv's build holds no wgmma (IGMMA) instruction: {sass}")
    nets, calls = int8_networks_phase(torch, card, ckpt)
    rows = int8_conv_cases(torch, calls, card)
    edges = int8_edge_cases(torch, card)
    fresh = int8_split_fresh_stream(torch, card)
    shape, kh = INT8_LINE_CASE
    line_call = next(c for c in calls if tuple(c.xq.shape) == shape and c.geom.kh == kh
                     and c.w.shape[0] == shape[3])
    host = int8_call_host_us(torch, line_call)
    print(f"  int8 conv host µs a call (x{list(shape)}, {kh}x{kh}): int8_conv "
          f"{host['int8_conv']:.1f}, through the custom op {host['custom_op']:.1f}; on {card}",
          flush=True)
    del calls, line_call
    torch.cuda.empty_cache()
    for r in rows:
        dev = "not measured" if r["device_us"] is None else f"{r['device_us']:.2f} us"
        pl = r["plan"]
        print(f"  int8 conv x{r['x']} -> {r['cout']} k {r['k']} geom {r['geom']} "
              f"{r['out']}/{r['act']}/{r['residual']} (C padded {r['cp']}; tile {pl['bm']}x"
              f"{pl['bn']}, {pl['splits']} K slices, {pl['phases']} phases"
              f"{', split-K = one slice' if r.get('split_k_equal_one_slice') else ''}): "
              f"{r['ms']:.4f} ms, device "
              f"{dev}, bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bound_by']}), plain {r['plain_ms']:.3f} ms, _int_mm "
              f"{r['library_ms']:.4f} ms, cuDNN fp32 {r['cudnn_fp32_ms']:.4f} / bf16 "
              f"{r['cudnn_bf16_ms']:.4f} ms", flush=True)
    line = next(r for r in rows if r["x"] == list(shape) and r["geom"][0] == kh
                and r["cout"] == shape[3])
    sv = int8_serving_phase(torch, tmp, card, ckpt, tree)
    from supervised_dispnet_tpu_torch.ops.cuda import int8_conv as ic

    ic.reset_counts()
    fp = _run_eval(tmp, tree, ckpt, "int8_fp32")
    q = _run_eval(tmp, tree, ckpt, "int8", "--int8", "--calib-batches", "1",
                  "--percentile", "99.9")
    if not ic.int8_conv_launches:
        raise AssertionError("the eval CLI's --int8 launched no int8 conv")
    ev = {"fp32": fp["table"], "int8": q["table"], "fp32_wall_s": fp["wall_s"],
          "int8_wall_s": q["wall_s"], "int8_conv_launches": ic.int8_conv_launches}
    tr = int8_train_phase(torch, tmp / "qat", card)
    exp = int8_export_phase(torch, tmp, card, ckpt)
    entry = {"name": "int8_conv", "route": "cuda",
             "source": "supervised_dispnet_tpu_torch/csrc/int8_conv.cu",
             "replaces": "supervised_dispnet_tpu/ops/quant.py:367 (XLA's int8 conv in "
                         "_conv_q, no pallas_call)",
             "launches": nets["disp_res_50-fused"]["launches"],
             "max_abs_err": max(r["max_abs_err"] for r in rows), "ms": line["ms"],
             "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
             "bound_by": line["bound_by"], "library_ms": line["library_ms"],
             "device_us": line["device_us"], "shape": line["x"]}
    wall = time.perf_counter() - t0
    print(f"  int8 phase: {wall:.1f} s", flush=True)
    return {"networks": nets, "conv_cases": rows, "serving": sv, "eval": ev, "qat": tr,
            "export": exp, "sass": sass, "edge_cases": edges,
            "split_fresh_stream": fresh, "host_us": host,
            "wall_s": wall}, entry


PARALLEL_RANKS = (1, 2)  # the 1-rank run (NCCL) and the 2-rank run (gloo, one card)
PARALLEL_KINDS = ("berhu", "classification", "selfsup")
PARALLEL_TRAIN_STEPS = 3
PARALLEL_TIMED_STEPS = 3
PARALLEL_ENCODERS = ("disp.encoder.", "disp.conv", "pose.conv")  # rel-L2 5e-2 (ROADMAP C4)
# the decoder and heads' rel-L2 limit, 2 ranks against 1: 1e-3; the
# self-supervised step's 5e-3, as two runs of that step alone on the card
# part by ~3.5e-4 and up to ~1e-3 on a gradient whose terms cancel (C4)
PARALLEL_DECODER_LIMIT = {"berhu": 1e-3, "classification": 1e-3, "selfsup": 5e-3}
# each configuration's launches a step on every rank of the 2-rank run
PARALLEL_LAUNCHES = {
    "berhu": {"berhu_fwd_launches": 1, "berhu_fwd_given_c_launches": 1,
              "berhu_bwd_launches": 1},
    "classification": {"ce_fwd_launches": 4, "ce_bwd_launches": 4},  # 1 + 1 a scale
    "selfsup": {"warp_fwd_launches": 1, "warp_bwd_coords_launches": 1},
}


def berhu_given_c_check(torch) -> dict:
    """The given-threshold BerHu forward (``berhu_forward_given_c``, the
    second forward launch of a data-parallel step) against the plain
    version with the same c, for a group of 1 and one of 4 at the main
    shape, with the forward's own c and with c scaled by 0.6 and by 1.7 (a
    rank's c is the max over all ranks, not its own): the weighted total
    rtol 1e-5, the gradients (the unchanged backward, reading the given c)
    atol 1e-6; each problem's count exact; two runs bit-equal. Then its
    time, the plain version's and the bound."""
    from supervised_dispnet_tpu_torch.losses.supervised import berhu_loss_plain
    from supervised_dispnet_tpu_torch.ops.cuda import losses as kl

    rng = np.random.default_rng(21)
    err_l = err_g = 0.0
    for P in (1, 4):
        preds, gt, mask = _berhu_group(torch, rng, MAIN_SHAPE, P)
        weights = STEP_WEIGHTS[:P]
        own = kl.berhu_forward_many(preds, gt, mask, weights)[2:3 * P:3].contiguous()
        for scale in (1.0, 0.6, 1.7):
            c = (own * scale).contiguous()
            reqs = [p.clone().requires_grad_(True) for p in preds]
            total = kl.berhu_loss_many_cuda(reqs, gt, mask, weights, c=c)
            total.backward()
            plain = [p.clone().requires_grad_(True) for p in preds]
            ref = torch.zeros((), device=gt.device)
            for s, (p, w) in enumerate(zip(plain, weights)):
                ref = ref + w * berhu_loss_plain(p, gt, mask, c=c[s])
            ref.backward()
            sums = kl.berhu_forward_given_c(preds, gt, mask, c)
            again = kl.berhu_forward_given_c(preds, gt, mask, c)
            reqs2 = [p.clone().requires_grad_(True) for p in preds]
            kl.berhu_loss_many_cuda(reqs2, gt, mask, weights, c=c).backward()
            torch.cuda.synchronize()
            e_l = abs(float(total.detach()) - float(ref.detach()))
            e_g = max(float((a.grad - b.grad).abs().max()) for a, b in zip(reqs, plain))
            err_l, err_g = max(err_l, e_l), max(err_g, e_g)
            count = float(mask.to(torch.float32).sum())
            ok = (math.isclose(float(total.detach()), float(ref.detach()), rel_tol=1e-5) and e_g <= 1e-6
                  and float(sums[P]) == count and torch.equal(sums, again)
                  and all(torch.equal(a.grad, b.grad) for a, b in zip(reqs, reqs2)))
            print(f"  berhu given c, P={P}, c x {scale}: total kernel {float(total.detach()):.7g} plain "
                  f"{float(ref.detach()):.7g} (abs err {e_l:.3g}); grad max abs err {e_g:.3g}; count "
                  f"{float(sums[P]):.0f}; two runs bit-equal", flush=True)
            if not ok:
                raise AssertionError(f"the given-c BerHu forward disagrees with the plain "
                                     f"version (P={P}, c x {scale}) or with itself")
    # timings at the step's group of 4
    preds, gt, mask = _berhu_group(torch, rng, MAIN_SHAPE, 4)
    c = kl.berhu_forward_many(preds, gt, mask, STEP_WEIGHTS)[2:12:3].contiguous()

    def plain_fwd():
        total = torch.zeros((), device=gt.device)
        for s, (p, w) in enumerate(zip(preds, STEP_WEIGHTS)):
            total = total + w * berhu_loss_plain(p, gt, mask, c=c[s])
        return total

    n, P = gt.numel(), 4
    ms = cuda_ms(torch, lambda: kl.berhu_forward_given_c(preds, gt, mask, c))
    plain_ms = cuda_ms(torch, plain_fwd)
    # the profiler can drop a kernel's events: up to 3 profiles, else the
    # device time is not measured (None), never read as 0
    name = "berhu_forward_given_c_group_kernel"
    for _ in range(3):
        us, per_call = device_us(torch, lambda: kl.berhu_forward_given_c(preds, gt, mask, c),
                                 (name,))[name]
        if per_call > 0:
            break
    dev_us = us if per_call > 0 else None
    # read the 4 predictions, gt (f32), the 1-byte mask and c once, write
    # the P + 1 sums; ~8 flops an element and problem
    bound = bound_ms((4 * P + 5) * n + 4 * P + 4 * (P + 1), 8 * P * n)
    shown = "not measured (no event in 3 profiles)" if dev_us is None else f"{dev_us:.2f}"
    print(f"  berhu given c, step group (4 problems): kernel_ms {ms:.5f} plain_ms "
          f"{plain_ms:.5f} device_us {shown} bound_us {bound[0] * 1e3:.3f}; "
          f"library_ms null", flush=True)
    return {"name": "berhu_fwd_given_c", "route": "cuda",
            "source": "supervised_dispnet_tpu_torch/csrc/berhu.cu",
            "replaces": f"{TPU_KERNEL}:203", "max_abs_err": max(err_l, err_g), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None, "device_us": dev_us, "problems": P}


def _launch_ranks(n: int, out: Path, cli: list[str], timeout: float = 600.0,
                  extra: tuple[str, ...] = (), steps: int = PARALLEL_TIMED_STEPS) -> list[dict]:
    """``scripts/torch_parallel_run.py`` on ``n`` ranks of this card under
    ``torch.distributed.run`` (a free localhost port), with ``extra``
    arguments; each rank's record."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", str(n), "--master-addr", "127.0.0.1", "--master-port",
           str(_free_port()), str(REPO / "scripts" / "torch_parallel_run.py"), str(out),
           "--steps", str(steps), *extra, "--", *cli]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    tail = (proc.stdout[-3000:] + proc.stderr[-3000:])
    if proc.returncode:
        raise AssertionError(f"{n}-rank run exited {proc.returncode}:\n{tail}")
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(n)]
    print(f"  parallel: {n} rank(s) ran in {wall:.1f} s; backend "
          f"{ranks[0]['backend']}; {[r['device'] for r in ranks]}", flush=True)
    for line in proc.stdout.splitlines():
        if line.startswith("=> data-parallel"):
            print(f"    {line}", flush=True)
    return ranks


def parallel_phase(torch, tmp: Path, card: str) -> tuple[dict, dict]:
    """Data-parallel training (``parallel/mesh.py``) on this card: the
    given-c BerHu forward against its plain version
    (``berhu_given_c_check``); then ``scripts/torch_parallel_run.py`` under
    ``torch.distributed.run`` on 1 rank (NCCL) and on 2 ranks sharing the
    card (gloo), in a subprocess each: a sum and a max over the ranks; one
    step of each
    configuration of the slice (DispResNet-50 BerHu, DispResNet-50
    multi-scale classification, DispNetS + PoseExpNet) from the same seeded
    weights on the same global batch of 4 at 128x416, 2 ranks against 1 (loss
    rtol 1e-4; decoder and head gradients rel-L2 1e-3, the self-supervised
    step's 5e-3, as two runs of that step alone part by up to ~1e-3, C4;
    encoder gradients rel-L2 5e-2, C4; BN running statistics rel-L2 1e-3),
    with each rank's launches (BerHu 2 forward + 1 backward on 2 ranks, 1 + 1 on one;
    CE 1 + 1 a scale; warp 1 grouped forward + 1 coordinate-only backward)
    and its step times and collective time; then 3 steps of DispResNet-50
    BerHu through ``cli.train`` on each (BerHu 2 + 1 launches a step on each
    of 2 ranks, 1 + 1 on one), their checkpoints' decoder and heads within
    ``dispatch_gap`` 5% of each other. The encoder's gap is printed, not
    held: Adam's first updates take the sign of gradient entries that
    rounding decides, and the encoder's (ROADMAP C4) part by 1.8e-2 rel-L2
    between 1 and 2 ranks; a rerun of the same 1-rank run already parts by
    6.5% over the whole net after 3 steps (scripts/torch_parallel_spread.py,
    PERF.md). Returns the
    summary and the given-c kernel's line entry (its launches: the 2-rank
    CLI run's, on rank 0)."""
    from supervised_dispnet_tpu_torch.models import get_disp_net

    entry = berhu_given_c_check(torch)
    B, H, W = MAIN_SHAPE
    write_packed(tmp / "data", np.random.default_rng(1), H, W)
    runs = {}
    for n in PARALLEL_RANKS:
        cli = [str(tmp / "data"), "--network", "disp_res_50", "--loss", "berhu", "-b", str(B),
               "--epoch-size", str(PARALLEL_TRAIN_STEPS), "--epochs", "1", "--with-gt",
               "--checkpoints-dir", str(tmp / f"ck{n}"), "--name", "parallel"]
        # the 1-rank run also makes the spatial phase's references
        kinds = (*PARALLEL_KINDS, *(("berhu18", "memory") if n == 1 else ()))
        runs[n] = _launch_ranks(n, tmp / f"ranks{n}", cli, extra=("--kinds", ",".join(kinds)))
    one, two = runs[1], runs[2]
    if one[0]["backend"] != "nccl" or any(r["backend"] != "gloo" for r in two):
        raise AssertionError(f"backends {one[0]['backend']} / {[r['backend'] for r in two]}: "
                             "want nccl on one rank, gloo for two ranks on one card")
    if not all(r["collectives"] for r in one + two):
        raise AssertionError("a sum or max over the ranks came out wrong")
    report = {"card": card, "steps": {}}
    for kind in PARALLEL_KINDS:
        ref = torch.load(tmp / "ranks1" / f"{kind}.pt", weights_only=False)
        got = torch.load(tmp / "ranks2" / f"{kind}.pt", weights_only=False)
        if not math.isclose(got["loss"], ref["loss"], rel_tol=1e-4):
            raise AssertionError(f"parallel {kind}: loss {got['loss']} on 2 ranks, "
                                 f"{ref['loss']} on 1")
        rels = {k: _rel_l2(got["grads"][k], g) for k, g in ref["grads"].items()}
        bad = [f"{k} {r:.3g}" for k, r in rels.items()
               if r > (5e-2 if k.startswith(PARALLEL_ENCODERS) else PARALLEL_DECODER_LIMIT[kind])]
        bn = {k: _rel_l2(got["bn"][k], v) for k, v in ref["bn"].items()}
        bad += [f"{k} {r:.3g}" for k, r in bn.items() if r > 1e-3]
        if bad or set(rels) != set(got["grads"]):
            raise AssertionError(f"parallel {kind}: 2 ranks against 1: {bad[:8]}")
        want = PARALLEL_LAUNCHES[kind]
        for r in two:
            seen = {k: v for k, v in r["steps"][kind]["launches"].items() if v}
            if seen != want:
                raise AssertionError(f"parallel {kind} rank {r['rank']}: launches {seen}, "
                                     f"want {want}")
        seen1 = {k: v for k, v in one[0]["steps"][kind]["launches"].items() if v}
        want1 = {k: v for k, v in want.items() if k != "berhu_fwd_given_c_launches"}
        if seen1 != want1:
            raise AssertionError(f"parallel {kind} on 1 rank: launches {seen1}, want {want1}")
        dec = [r for k, r in rels.items() if not k.startswith(PARALLEL_ENCODERS)]
        worst = max((k for k in rels if not k.startswith(PARALLEL_ENCODERS)), key=rels.get)
        enc = [r for k, r in rels.items() if k.startswith(PARALLEL_ENCODERS)]
        times = {n: [r["steps"][kind] for r in runs[n]] for n in PARALLEL_RANKS}
        med = {n: [float(np.median(t["step_ms"])) for t in times[n]] for n in PARALLEL_RANKS}
        coll = {n: [float(np.median(t["collective_ms"])) for t in times[n]]
                for n in PARALLEL_RANKS}
        report["steps"][kind] = {
            "loss": [ref["loss"], got["loss"]], "decoder_rel_l2_max": max(dec),
            "decoder_rel_l2_worst": worst,
            "encoder_rel_l2_max": max(enc) if enc else None,
            "bn_rel_l2_max": max(bn.values()) if bn else None,
            "launches_a_rank": {n: runs[n][0]["steps"][kind]["launches"]
                                for n in PARALLEL_RANKS},
            "step_ms_median": med, "collective_ms_median": coll}
        print(f"  parallel {kind}: loss {ref['loss']:.7g} (1 rank) / {got['loss']:.7g} "
              f"(2 ranks); decoder and head gradients rel-L2 max {max(dec):.3g} ({worst}; "
              f"limit {PARALLEL_DECODER_LIMIT[kind]:g})"
              + (f", encoder {max(enc):.3g}" if enc else "")
              + (f", BN statistics {max(bn.values()):.3g}" if bn else "")
              + f"; launches a rank {want}; step ms median 1 rank {med[1][0]:.2f}, "
              f"2 ranks {[round(m, 2) for m in med[2]]} (collectives "
              f"{[round(c, 2) for c in coll[2]]} ms), on {card}", flush=True)
    # the CLI's 3 steps: launches a rank, and the checkpoints side by side
    train = {n: [r["train"] for r in runs[n]] for n in PARALLEL_RANKS}
    for n in PARALLEL_RANKS:
        for r, t in enumerate(train[n]):
            steps = t["steps"]
            want = {"berhu_fwd_launches": steps, "berhu_bwd_launches": steps,
                    **({"berhu_fwd_given_c_launches": steps} if n > 1 else {})}
            seen = {k: v for k, v in t["launches"].items() if v}
            if steps != PARALLEL_TRAIN_STEPS or seen != want:
                raise AssertionError(f"parallel CLI, {n} rank(s), rank {r}: {steps} steps, "
                                     f"launches {seen}, want {want}")
    ckpts = {n: sorted((tmp / f"ck{n}" / "parallel").glob("*/dispnet_checkpoint.pth.tar"))
             for n in PARALLEL_RANKS}
    if any(len(c) != 1 for c in ckpts.values()):
        raise AssertionError(f"want one checkpoint a run, got {ckpts}")
    init = dict(get_disp_net("disp_res_50", seed=0, device="cpu").named_parameters())
    sds = {n: torch.load(c[0], map_location="cpu", weights_only=True)["state_dict"]
           for n, c in ckpts.items()}

    def gap(names):
        return dispatch_gap(torch, (None, [sds[2][k] for k in names]),
                            ([init[k].detach() for k in names], [sds[1][k] for k in names]))

    enc = [k for k in init if k.startswith("encoder.")]
    gaps = {"decoder_and_heads": gap([k for k in init if k not in enc]),
            "encoder": gap(enc), "all": gap(list(init))}
    print(f"  parallel CLI: 3 DispResNet-50 BerHu steps on 1 rank (nccl) and on 2 ranks "
          f"(gloo): checkpoints apart by {gaps['decoder_and_heads']:.4f} of the 1-rank run's "
          f"movement over the decoder and heads (limit 0.05); the encoder's "
          f"{gaps['encoder']:.4f}, all {gaps['all']:.4f} (not held: ROADMAP C4); wall "
          f"{train[1][0]['wall_s']:.1f} s / {train[2][0]['wall_s']:.1f} s", flush=True)
    if gaps["decoder_and_heads"] > 0.05:
        raise AssertionError(f"parallel CLI: the 2-rank checkpoint's decoder and heads are "
                             f"{gaps['decoder_and_heads']:.4f} of the 1-rank run's movement "
                             "away from it (limit 0.05)")
    report["cli"] = {"dispatch_gap": gaps, "launches": {n: [t["launches"] for t in train[n]]
                                                        for n in PARALLEL_RANKS},
                     "wall_s": {n: [t["wall_s"] for t in train[n]] for n in PARALLEL_RANKS}}
    entry["launches"] = train[2][0]["launches"]["berhu_fwd_given_c_launches"]
    return report, entry


SPATIAL_KINDS = ("berhu", "classification")
SPATIAL_TIMED_STEPS = 3
SPATIAL_TRAIN_STEPS = 3


def _parallel_runner():
    """``scripts/torch_parallel_run.py`` as a module (its seeded batches)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_parallel_run",
                                                  REPO / "scripts" / "torch_parallel_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hold_step(torch, kind: str, ref: dict, got: dict, what: str) -> dict:
    """One step of ``got`` against ``ref`` (the runner's saved loss,
    gradients and BN statistics): the loss rel 1e-5; decoder and head
    gradients rel-L2 within the parallel phase's limit; the encoder's
    finite and within C4's 5e-2; BN statistics within the parallel phase's
    1e-3. Returns the figures."""
    rel_loss = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    rels = {k: _rel_l2(got["grads"][k], g) for k, g in ref["grads"].items()}
    bad = [f"{k} {r:.3g}" for k, r in rels.items()
           if not (r <= (5e-2 if k.startswith(PARALLEL_ENCODERS)
                         else PARALLEL_DECODER_LIMIT[kind]))]
    bad += [k for k, g in got["grads"].items() if not bool(torch.isfinite(g).all())]
    bn = {k: _rel_l2(got["bn"][k], v) for k, v in ref["bn"].items()}
    bad += [f"{k} {r:.3g}" for k, r in bn.items() if not r <= 1e-3]
    if rel_loss > 1e-5 or bad or set(rels) != set(got["grads"]):
        raise AssertionError(f"spatial {what}: loss rel {rel_loss:.3g} (limit 1e-5); {bad[:8]}")
    dec = {k: r for k, r in rels.items() if not k.startswith(PARALLEL_ENCODERS)}
    enc = [r for k, r in rels.items() if k.startswith(PARALLEL_ENCODERS)]
    return {"loss": [ref["loss"], got["loss"]], "loss_rel": rel_loss,
            "decoder_rel_l2_max": max(dec.values()), "decoder_worst": max(dec, key=dec.get),
            "encoder_rel_l2_max": max(enc), "bn_rel_l2_max": max(bn.values())}


def spatial_guard(torch) -> str:
    """H = 64 at 4 spatial shards on DispResNet-18 (stride 32): the step
    raises ``ValueError`` naming spatial partitioning before any collective
    (the mesh's collectives raise ``AssertionError``)."""
    from supervised_dispnet_tpu_torch.models import get_disp_net
    from supervised_dispnet_tpu_torch.parallel.mesh import Mesh
    from supervised_dispnet_tpu_torch.training.train_step import make_supervised_train_step

    class NoCollectives(Mesh):
        def all_reduce_(self, t, op="sum"):
            raise AssertionError("a collective ran before the guard")

        def exchange(self, t):
            raise AssertionError("a halo exchange ran before the guard")

    model = get_disp_net("disp_res_18", device=CARD)
    step = make_supervised_train_step(model, torch.optim.Adam(model.parameters()), "berhu",
                                      mesh=NoCollectives(size=4, spatial=4))
    batch = {"tgt": torch.zeros(1, 64, 416, 3, dtype=torch.uint8, device=CARD),
             "intrinsics": torch.eye(3, device=CARD)[None],
             "depth": torch.ones(1, 64, 416, device=CARD)}
    try:
        step(batch)
    except ValueError as e:
        if "spatial partitioning" not in str(e):
            raise
        return str(e)
    raise AssertionError("the spatial guard did not raise at H = 64, 4 shards")


def spatial_phase(torch, tmp: Path, card: str, parallel_tmp: Path) -> dict:
    """Spatial partitioning on this card (``parallel/spatial.py``), through
    ``scripts/torch_parallel_run.py`` under ``torch.distributed.run``:

    - 2 ranks of one spatial group sharing the card (gloo): one step of
      DispResNet-50 BerHu and of multi-scale classification (64 bins) at
      128x416, a global batch of 4, against the parallel phase's 1-rank run
      of the same weights and batch (``_hold_step``), each rank's launches
      (BerHu 1 grouped + 1 given-c forward + 1 backward, CE 4 + 4), step ms
      and the all-reduces' and halo exchanges' ms; DispResNet-50 BerHu at
      384x1280, a global batch of 2, each shard's
      ``torch.cuda.max_memory_allocated`` below one rank's (the parallel
      phase's 1-rank launch, which also steps DispResNet-18 for the 2 x 2
      reference); 3 BerHu steps through ``cli.train`` with
      ``--spatial-shards 2`` (1 + 1 + 1 launches a step a rank), then its
      model's eval on a seeded batch on the 2 shards against a 1-rank eval
      of its checkpoint here: the depth maps rtol 1e-4, the error metrics
      rtol 1e-4, the threshold fractions a1..a3 within 10 of the batch's
      valid pixels (a pixel whose depth ratio lies within rounding of
      1.25^k goes either way: 2 of 21,000 did in a first run);
    - DispResNet-18 BerHu on 2 data x 2 spatial ranks (4 on the card)
      against 1 rank (``_hold_step``);
    - the guard (``spatial_guard``)."""
    from supervised_dispnet_tpu_torch.models import get_disp_net
    from supervised_dispnet_tpu_torch.parallel.mesh import Mesh
    from supervised_dispnet_tpu_torch.data.augment import normalize_images
    from supervised_dispnet_tpu_torch.training.train_step import (
        imgs_to_float, make_eval_step, output_depth)
    from supervised_dispnet_tpu_torch.training.trainer import TrainerConfig, aug_config
    from supervised_dispnet_tpu_torch.utils.device import set_fp32_math

    t0 = time.perf_counter()
    B, H, W = MAIN_SHAPE
    write_packed(tmp / "data", np.random.default_rng(2), H, W)
    cli = [str(tmp / "data"), "--network", "disp_res_50", "--loss", "berhu", "-b", str(B),
           "--epoch-size", str(SPATIAL_TRAIN_STEPS), "--epochs", "1", "--with-gt",
           "--checkpoints-dir", str(tmp / "ck"), "--name", "spatial", "--spatial-shards", "2"]
    two = _launch_ranks(2, tmp / "ranks2", cli, steps=SPATIAL_TIMED_STEPS, extra=(
        "--kinds", ",".join((*SPATIAL_KINDS, "memory")), "--spatial-shards", "2",
        "--eval-batch"))
    four = _launch_ranks(4, tmp / "ranks4", [], steps=1, extra=(
        "--kinds", "berhu18", "--spatial-shards", "2"))
    # the parallel phase's 1-rank run: DispResNet-18 BerHu and the 384x1280 peak
    one = [json.loads((parallel_tmp / "ranks1" / "rank0.json").read_text())]
    if any(r["backend"] != "gloo" or r["spatial"] != 2 for r in two + four):
        raise AssertionError("want gloo ranks in spatial groups of 2")
    if not all(r["collectives"] for r in two + four):
        raise AssertionError("a sum or max over the ranks came out wrong")
    report = {"card": card, "steps": {}}
    for kind in SPATIAL_KINDS:
        ref = torch.load(parallel_tmp / "ranks1" / f"{kind}.pt", weights_only=False)
        got = torch.load(tmp / "ranks2" / f"{kind}.pt", weights_only=False)
        held = _hold_step(torch, kind, ref, got, f"{kind}, 1 x 2 against 1 rank")
        want = PARALLEL_LAUNCHES[kind]
        for r in two:
            seen = {k: v for k, v in r["steps"][kind]["launches"].items() if v}
            if seen != want:
                raise AssertionError(f"spatial {kind} rank {r['rank']}: launches {seen}, "
                                     f"want {want}")
        med = {k: [float(np.median(r["steps"][kind][k])) for r in two]
               for k in ("step_ms", "collective_ms", "halo_ms")}
        report["steps"][kind] = {**held, "launches_a_rank": want, **{f"{k}_median": v
                                                                      for k, v in med.items()}}
        print(f"  spatial {kind}, DispResNet-50 128x416 B=4 on 1 x 2 ranks (gloo, one card) "
              f"against 1 rank: loss {held['loss'][1]:.7g} / {held['loss'][0]:.7g} (rel "
              f"{held['loss_rel']:.3g}, limit 1e-5); decoder and head gradients rel-L2 max "
              f"{held['decoder_rel_l2_max']:.3g} ({held['decoder_worst']}; limit "
              f"{PARALLEL_DECODER_LIMIT[kind]:g}), encoder {held['encoder_rel_l2_max']:.3g} "
              f"(limit 5e-2), BN statistics {held['bn_rel_l2_max']:.3g}; launches a rank "
              f"{want}; step ms median a rank {[round(m, 2) for m in med['step_ms']]}, "
              f"all-reduces {[round(m, 2) for m in med['collective_ms']]} ms, halo exchanges "
              f"{[round(m, 2) for m in med['halo_ms']]} ms, on {card}", flush=True)
    # the 2 x 2 mesh
    ref = torch.load(parallel_tmp / "ranks1" / "berhu18.pt", weights_only=False)
    got = torch.load(tmp / "ranks4" / "berhu18.pt", weights_only=False)
    held = _hold_step(torch, "berhu", ref, got, "DispResNet-18, 2 x 2 against 1 rank")
    for r in four:
        seen = {k: v for k, v in r["steps"]["berhu18"]["launches"].items() if v}
        if seen != PARALLEL_LAUNCHES["berhu"]:
            raise AssertionError(f"spatial 2 x 2 rank {r['rank']}: launches {seen}")
    report["mesh_2x2"] = {**held, "step_ms": [r["steps"]["berhu18"]["step_ms"] for r in four],
                          "halo_ms": [r["steps"]["berhu18"]["halo_ms"] for r in four],
                          "collective_ms": [r["steps"]["berhu18"]["collective_ms"]
                                            for r in four]}
    print(f"  spatial DispResNet-18 BerHu 128x416 B=4 on 2 data x 2 spatial ranks (4 on the "
          f"card) against 1 rank: loss rel {held['loss_rel']:.3g}; decoder and heads rel-L2 "
          f"max {held['decoder_rel_l2_max']:.3g}, encoder {held['encoder_rel_l2_max']:.3g}, "
          f"BN {held['bn_rel_l2_max']:.3g}; step ms {[round(s[0], 1) for s in report['mesh_2x2']['step_ms']]}",
          flush=True)
    # what the feature is for: each shard's peak memory at 384x1280
    peak1 = one[0]["steps"]["memory"]["max_memory_allocated"]
    peaks = [r["steps"]["memory"]["max_memory_allocated"] for r in two]
    report["memory_384x1280"] = {
        "peak_bytes_1_rank": peak1, "peak_bytes_shards": peaks,
        "ratio": [p / peak1 for p in peaks],
        "step_ms_1_rank": one[0]["steps"]["memory"]["step_ms"],
        "step_ms_shards": [r["steps"]["memory"]["step_ms"] for r in two],
        "halo_ms_shards": [r["steps"]["memory"]["halo_ms"] for r in two],
        "collective_ms_shards": [r["steps"]["memory"]["collective_ms"] for r in two]}
    print(f"  spatial DispResNet-50 BerHu 384x1280 B=2: peak max_memory_allocated 1 rank "
          f"{peak1 / 2**20:.1f} MiB, shards {[round(p / 2**20, 1) for p in peaks]} MiB (ratio "
          f"{[round(p / peak1, 4) for p in peaks]}); step ms 1 rank "
          f"{one[0]['steps']['memory']['step_ms'][0]:.1f}, shards "
          f"{[round(r['steps']['memory']['step_ms'][0], 1) for r in two]} (halo "
          f"{[round(r['steps']['memory']['halo_ms'][0], 1) for r in two]} ms), on {card}",
          flush=True)
    if not all(p < peak1 for p in peaks):
        raise AssertionError(f"a shard's peak {peaks} is not below one rank's {peak1}")
    # the CLI: launches a step, then its checkpoint's eval, 2 shards against 1 rank
    steps = SPATIAL_TRAIN_STEPS
    want = {"berhu_fwd_launches": steps, "berhu_fwd_given_c_launches": steps,
            "berhu_bwd_launches": steps}
    for r in two:
        seen = {k: v for k, v in r["train"]["launches"].items() if v}
        if r["train"]["steps"] != steps or seen != want:
            raise AssertionError(f"spatial CLI rank {r['rank']}: {r['train']['steps']} steps, "
                                 f"launches {seen}, want {want}")
    ckpts = sorted((tmp / "ck" / "spatial").glob("*/dispnet_checkpoint.pth.tar"))
    if len(ckpts) != 1:
        raise AssertionError(f"want one checkpoint, got {ckpts}")
    model = get_disp_net("disp_res_50", device=CARD)
    model.load_state_dict(torch.load(ckpts[0], map_location=CARD,
                                     weights_only=True)["state_dict"], strict=True)
    # full float32, as the ranks' trainers set it, whatever phase ran
    # before: with PyTorch's default TF32 convolutions this 1-rank eval, not
    # the 2 shards', is the one that parts from a float64 eval by over 1e-4
    set_fp32_math()
    batch = _parallel_runner().global_batch("berhu")
    val = {"img": torch.as_tensor(batch["tgt"], device=CARD),
           "depth": torch.as_tensor(batch["depth"], device=CARD)}
    aug = aug_config(TrainerConfig())
    one_eval = {k: float(v) for k, v in make_eval_step(model, aug=aug, mesh=Mesh())(val).items()}
    with torch.no_grad():
        depth = output_depth(model(normalize_images(imgs_to_float(val["img"]), aug.mean,
                                                    aug.std))).cpu()
    two_depth = torch.cat([torch.load(tmp / "ranks2" / f"eval_depth{r}.pt") for r in range(2)],
                          dim=1)
    rel = (two_depth - depth).abs() / depth.abs()
    depth_rel = float(rel.max())
    valid = float(((val["depth"] > 0) & (val["depth"] < 80.0)).sum())
    digests = [r["train"]["eval"].pop("state_digest") for r in two]
    two_eval = two[0]["train"]["eval"]
    bad = [] if digests == [_parallel_runner().state_digest(model)] * 2 else [
        "the ranks' models and the checkpoint differ"]
    bad += [k for k in one_eval if not (
        abs(two_eval[k] - one_eval[k]) * valid <= 10 if k in ("a1", "a2", "a3")
        else math.isclose(two_eval[k], one_eval[k], rel_tol=1e-4, abs_tol=1e-7))]
    if depth_rel > 1e-4:
        where = torch.nonzero(rel == rel.max())[0].tolist()
        bad.append(f"depth map rel {depth_rel:.3g} ({int((rel > 1e-4).sum())} pixels over 1e-4; "
                   f"the worst at (b, y, x) {where[:3]} of {list(rel.shape[:3])}: "
                   f"{float(two_depth[tuple(where)]):.6g} against {float(depth[tuple(where)]):.6g})")
    print(f"  spatial CLI: {steps} DispResNet-50 BerHu steps on 2 spatial ranks, wall "
          f"{two[0]['train']['wall_s']:.1f} s; launches a rank {want}; the checkpoint's eval "
          f"on 2 shards {json.dumps({k: round(v, 6) for k, v in two_eval.items()})} against 1 "
          f"rank {json.dumps({k: round(v, 6) for k, v in one_eval.items()})}; depth maps max "
          f"rel {depth_rel:.3g} (limit 1e-4); {valid:.0f} valid pixels", flush=True)
    if bad:
        raise AssertionError(f"spatial CLI: the 2-shard eval parts from the 1-rank eval of "
                             f"its checkpoint on {bad}")
    report["cli"] = {"launches": [r["train"]["launches"] for r in two],
                     "wall_s": [r["train"]["wall_s"] for r in two],
                     "eval_two_shards": two_eval, "eval_one_rank": one_eval,
                     "depth_rel_max": depth_rel}
    report["guard"] = spatial_guard(torch)
    print(f"  spatial guard: {report['guard']}", flush=True)
    report["phase_s"] = time.perf_counter() - t0
    print(f"  spatial phase: {report['phase_s']:.1f} s", flush=True)
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA card",
              file=sys.stderr)
        return 1
    if not (REPO / "supervised_dispnet_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (no "
              "supervised_dispnet_tpu_torch beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from supervised_dispnet_tpu_torch.ops.cuda import _build

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: {'; '.join(regs) or 'already built'}", flush=True)
    from supervised_dispnet_tpu_torch.utils import native

    t0 = time.perf_counter()
    log = native.build("image_codec")
    print(f"build: host codec {native.library_path('image_codec').name} with g++ in "
          f"{time.perf_counter() - t0:.2f} s{': ' + log.strip() if log.strip() else ''}",
          flush=True)

    kernels = {**kernel_phase(torch), **warp_phase(torch), **warp_group_phase(torch),
               **ce_phase(torch)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sl = slice_phase(torch, Path(tmp) / "berhu", card)
        ss = selfsup_phase(torch, Path(tmp) / "selfsup", card)
        cl = classification_phase(torch, Path(tmp) / "classification", card)
        cm = classification_phase(torch, Path(tmp) / "multiscale", card, multiscale=True)
        # the eval and inference paths run none of the port's kernels
        for mod, attr in kernel_counters():
            setattr(mod, attr, 0)
        tree = kitti_tree(Path(tmp))
        ev = eval_phase(torch, Path(tmp), card, tree, sl["checkpoint"], cl["checkpoint"])
        inf = inference_phase(torch, Path(tmp), tree, sl["checkpoint"])
        torch.cuda.synchronize()
        eval_launches = {attr: getattr(mod, attr) for mod, attr in kernel_counters()}
        if any(eval_launches.values()):
            raise AssertionError(f"the eval and inference paths launched kernels: "
                                 f"{eval_launches}")
        # nor do the pose evaluation and serving paths
        for mod, attr in kernel_counters():
            setattr(mod, attr, 0)
        po = pose_phase(torch, Path(tmp), card, ss["pose_checkpoint"])
        sv = serving_phase(torch, Path(tmp), card, sl["checkpoint"], tree)
        torch.cuda.synchronize()
        serve_launches = {attr: getattr(mod, attr) for mod, attr in kernel_counters()}
        if any(serve_launches.values()):
            raise AssertionError(f"the pose and serving paths launched kernels: "
                                 f"{serve_launches}")
        nets = networks_phase(torch, Path(tmp), card, tree)
        i8, i8_entry = int8_phase(torch, Path(tmp) / "int8", card, sl["checkpoint"], tree)
        opts = options_phase(torch, Path(tmp) / "options", card)
        arms = photometric_arms_phase(torch, Path(tmp) / "arms", card)
        loaders = device_loader_phase(torch, Path(tmp) / "loaders", card)
        etl = etl_phase(torch, Path(tmp) / "etl", card)
        par, par_entry = parallel_phase(torch, Path(tmp) / "parallel", card)
        spt = spatial_phase(torch, Path(tmp) / "spatial", card, Path(tmp) / "parallel")
    iw = inverse_warp_phase(torch)
    xc = {**cross_check(torch), **selfsup_cross_check(torch)}
    conv = convergence_phase(torch)

    # each kernel's launches on the path that runs it: BerHu on the
    # supervised path (its grouped launches: the single-problem entries
    # launch the same two kernels and count on the same counters), the forward and coordinate-only warp on the
    # self-supervised one (its grouped launches: the single-problem entries
    # launch the same two kernels and count on the same counters), the
    # image+coordinate warp on inverse_warp's, the CE on the (single-scale)
    # classification path
    launches = {**sl["launches"], "berhu_fwd_group": sl["launches"]["berhu_fwd"],
                "berhu_bwd_group": sl["launches"]["berhu_bwd"],
                **ss["launches"], "warp_bwd": iw["launches"]["warp_bwd"],
                "warp_fwd_group": ss["launches"]["warp_fwd"],
                "warp_bwd_coords_group": ss["launches"]["warp_bwd_coords"], **cl["launches"]}
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
    # the int8 conv's launches: one a quantized conv of DispResNet-50's int8
    # forward (fused decoder, both chains)
    kernels["int8_conv"] = i8_entry
    # the photometric arms' grouped launches (5 steps each; validation's
    # beside the CLI's arms) and the training-output image's single forward
    for name, key in (("warp_fwd_group", "warp_fwd"),
                      ("warp_bwd_coords_group", "warp_bwd_coords")):
        kernels[name]["arm_launches"] = {arm: arms[arm]["launches"][key] for arm in PHOTO_ARMS}
    kernels["warp_fwd"]["training_output_launches"] = arms["viz"]["single_image_launches"][
        "warp_fwd"]
    # the training runs from the ETL's JPEG dump tree (5 steps each)
    for name, run, key in (("berhu_fwd_group", "berhu", "berhu_fwd"),
                           ("berhu_bwd_group", "berhu", "berhu_bwd"),
                           ("warp_fwd_group", "selfsup", "warp_fwd"),
                           ("warp_bwd_coords_group", "selfsup", "warp_bwd_coords")):
        kernels[name]["etl_launches"] = etl["launches"][run][key]
    # the given-c BerHu forward: the 2-rank CLI run's launches (rank 0)
    kernels["berhu_fwd_given_c"] = par_entry
    if not all(e["launches"] > 0 for e in kernels.values()):
        raise AssertionError(f"a kernel was not launched on its path: {launches}")
    print(json.dumps({"slices": {
        name: {"step_ms": r["step_ms"], "step_ms_tf32": r["step_ms_tf32"], "card": card,
               "val": r["val"],
               "launches": r["launches"], "profile": r["profile"]}
        for name, r in (("supervised_berhu_dispresnet50", sl),
                        ("selfsup_dispnet_posexpnet", ss),
                        ("classification_dispresnet50", cl))},
        "classification_multiscale": {"launches": cm["launches"], "val": cm["val"]},
        "inverse_warp": iw, "cross_check": xc}))
    print(json.dumps({"eval": ev, "inference": inf, "eval_kernel_launches": eval_launches}))
    print(json.dumps({"pose": po, "serving": sv, "networks": nets,
                      "pose_serving_kernel_launches": serve_launches}))
    print(json.dumps({"options": opts}))
    print(json.dumps({"int8": i8}))
    print(json.dumps({"photometric_arms": arms, "loaders": loaders, "etl": etl,
                      "convergence": conv}))
    print(json.dumps({"parallel": par, "spatial": spt}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
