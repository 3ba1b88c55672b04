#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``supervised_dispnet_tpu_torch``) on one
CUDA card. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. print the card's name and power limit; build every CUDA kernel from
     ``supervised_dispnet_tpu_torch/csrc`` (one ``nvcc`` per source, all
     started together; timed);
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
       out-of-bounds coordinates, C=1 and a ragged (3, 37, 53);
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
     the plain versions, and against the CPU with the plain versions;
  5. a JSON line of the slice and cross-check numbers, a JSON line of kernel
     numbers, the card line, and as the last line
     ``{"ok": true, "device": {...}}``.

Imports nothing of JAX: the machine with the card has none.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
    # device time a launch; "" matches every device event of the call, so a
    # memset or another kernel would show as more events than the kernel's,
    # and a second launch as ~2 a call (the profiler may miss an event of
    # the 100: 0.99 a call)
    dev = {}
    for key, fn, kernel in (("fwd", fwd, "ce_forward_kernel"),
                            ("bwd", bwd, "ce_backward_kernel")):
        got = device_us(torch, fn, [kernel, ""], reps=100)
        if got[""][1] != got[kernel][1] or round(got[kernel][1]) != 1:
            raise AssertionError(f"ce {key}: {got} device events a call, not one {kernel}")
        dev[key] = got[kernel][0]
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


def _projection_coords(torch, B: int, H: int, W: int, seed: int):
    """Pixel coordinates as the main path's warp gets them: the target's
    pixels back-projected at a depth of 1 / disparity (disparity in the
    head's range) and projected into a reference frame moved by a small
    random pose, with KITTI intrinsics (``ops.warp``'s own functions)."""
    from supervised_dispnet_tpu_torch.ops import warp as wp

    g = torch.Generator().manual_seed(seed)
    disp = 10.0 * torch.sigmoid(torch.randn(B, H, W, generator=g)) + 0.01
    pose = 0.02 * torch.randn(B, 6, generator=g)
    K = torch.tensor(KITTI_K).expand(B, 3, 3) * torch.tensor(
        [[W / 416, 1, W / 416], [1, H / 128, H / 128], [1, 1, 1]])
    cam = wp.pixel2cam(1.0 / disp, torch.linalg.inv(K))
    proj = K @ wp.pose_vec2mat(pose)
    x, y, _ = wp.cam2pixel(cam, proj[:, :, :3], proj[:, :, 3:])
    return x, y


def _warp_case(torch, rng, shape, coords="projection", out_hw=None, seed=0,
               device="cuda"):
    """img (B, H, W, C) uniform in [-1, 1] (normalised images), coordinates
    (B, Ho, Wo), an upstream gradient (B, Ho, Wo, C) uniform in [-1, 1];
    all on the card. ``coords='random'`` spreads them over three times the
    image, most out of bounds."""
    B, H, W, C = shape
    Ho, Wo = out_hw or (H, W)
    if coords == "projection":
        x, y = _projection_coords(torch, B, H, W, seed)
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
    atol 1e-5 (atomics change the order of its sums from run to run); the
    coordinate-only backward's dx, dy bit-equal to the full backward's."""
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
    src = "supervised_dispnet_tpu_torch/csrc/warp.cu"
    return {
        name: {"name": name, "route": "cuda", "source": src, "replaces": f"{TPU_WARP}:{line}",
               "max_abs_err": err[name], "ms": t[key], "plain_ms": t[f"{key}_plain"],
               "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
               "library_ms": t[f"{key}_lib"]}
        for name, key, line in (("warp_fwd", "fwd", 114), ("warp_bwd", "bwd", 150),
                                ("warp_bwd_coords", "coords", 197))
    }


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
            "val": {k: epoch[k] for k in ("abs_rel", "rmse", "a1")}, **timed}


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
    out = {"launches": launches, "train_losses": losses, "val": val}
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


def profile_steps(torch, step, n: int = 5, top: int = 12) -> dict:
    """Device time of ``n`` steps by kernel, from ``torch.profiler``: the
    busy share of the steps' wall time, the ``top`` kernels by total device
    time, and the port's own kernels (their device time alone, where the
    CUDA-event times of the kernel phase include the host's call)."""
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
    return {"steps": n, "wall_ms_per_step": wall_us / n / 1e3,
            "busy_ms_per_step": busy_us / n / 1e3, "top": rows, "own_kernels": own}


def _grads_agree(g, ref, rtol: float = 1e-3) -> tuple[bool, float]:
    """|g - ref| <= rtol * |ref| + rtol * max|ref| elementwise; also returns
    the worst excess over that bound, relative to max|ref|."""
    scale = max(float(ref.abs().max()), 1e-30)
    excess = (g - ref).abs() - rtol * ref.abs()
    return bool((excess <= rtol * scale).all()), float(excess.max()) / scale


def _rel_l2(g, ref) -> float:
    return float((g - ref).norm() / ref.norm().clamp(min=1e-30))


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
)


def cross_check(torch, device: str = "cuda", checks=SUPERVISED_CHECKS) -> dict:
    """One supervised train step at the main-path shape from identical
    weights on one batch, augmentation off, TF32 off for cuDNN and matmul,
    for each of ``checks``: BerHu and the 64-bin classification CE
    (single- and multi-scale). Loss rtol 1e-4; gradients rtol 1e-3
    (``_grads_agree``: the two sides sum in other orders).

    - DispResNet-50 on the card, with the kernels against the plain BerHu
      or CE: the same convolutions on the same device, so every gradient
      must agree and only the loss kernels differ.
    - Card (kernels) against CPU (plain): the loss and the decoder's and
      heads' gradients. The encoder's gradients are
      compared by relative L2 norm, within 5e-2: in fp32 they are not fixed
      to 1e-3 by the inputs. A ReLU input within rounding of zero lands on
      the other side on the other device and takes its whole gradient with
      it; train-mode BN spreads that over the batch, and it reaches every
      encoder weight below it (PERF.md). The CPU's own fp32 step differs
      from its fp64 step in the same way.
    """
    from supervised_dispnet_tpu_torch.models import DispResNet

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
            base = DispResNet(**kwargs, generator=torch.Generator().manual_seed(3))
            l_a, g_a = _one_step(torch, copy.deepcopy(base).to(device), batch, device,
                                 loss=loss)
            l_b, g_b = _one_step(torch, copy.deepcopy(base).to(plain_dev), batch, plain_dev,
                                 plain=True, loss=loss)
            tag = f"{label} card vs {other}"
            strict = [n for n in g_b if plain_dev == device or not n.startswith("encoder.")]
            worst = 0.0
            for n in strict:
                ok, excess = _grads_agree(g_a[n], g_b[n])
                worst = max(worst, excess)
                if not ok:
                    raise AssertionError(f"cross-check {tag}: gradient {n} disagrees "
                                         f"(excess {excess:.3g})")
            rels = sorted(_rel_l2(g_a[n], g_b[n]) for n in g_b if n not in strict)
            if rels and rels[-1] > 5e-2:
                raise AssertionError(f"cross-check {tag}: encoder gradient rel-L2 "
                                     f"{rels[-1]:.3g} > 5e-2")
            if not math.isclose(l_a, l_b, rel_tol=1e-4):
                raise AssertionError(f"cross-check {tag}: loss {l_a} vs {l_b}")
            report[tag] = {"loss": [l_a, l_b], "rtol_1e-3_gradients": len(strict),
                           "worst_excess": worst,
                           "encoder_rel_l2_median": rels[len(rels) // 2] if rels else None,
                           "encoder_rel_l2_max": rels[-1] if rels else None}
            print(f"  cross-check {tag}: loss {l_a:.7g} / {l_b:.7g}; {len(strict)} "
                  f"gradients within rtol 1e-3 (worst excess {worst:.3g})"
                  + (f"; {len(rels)} encoder gradients rel-L2 median "
                     f"{rels[len(rels) // 2]:.3g} max {rels[-1]:.3g}" if rels else ""),
                  flush=True)
        return report
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _one_selfsup_step(torch, disp, pose, batch: dict, device, plain: bool = False):
    """One self-supervised train step (DispNetS + PoseExpNet), augmentation
    off; ``plain=True`` swaps the plain sampler in for the warp kernels.
    Returns ({loss, photo_loss, exp_loss, smooth_loss}, {name: grad on the
    CPU})."""
    from supervised_dispnet_tpu_torch.data.augment import AugmentConfig
    from supervised_dispnet_tpu_torch.ops import warp as wp
    from supervised_dispnet_tpu_torch.ops.sampling import bilinear_sample
    from supervised_dispnet_tpu_torch.training import train_step as ts

    no_aug = AugmentConfig(flip=False, scale_crop=False, color_jitter=False)
    opt = torch.optim.Adam(list(disp.parameters()) + list(pose.parameters()), lr=1e-4)
    step = ts.make_selfsup_train_step(disp, pose, opt, aug=no_aug)
    kernel_sample, kernel_many = wp.sample, wp.sample_many
    if plain:
        wp.sample = lambda i, x, y, mode, diff_img: bilinear_sample(
            i if diff_img else i.detach(), x, y, mode)
        wp.sample_many = lambda imgs, xs, ys, mode: [
            bilinear_sample(i.detach(), x, y, mode) for i, x, y in zip(imgs, xs, ys)]
    try:
        out = step({k: torch.from_numpy(v).to(device) for k, v in batch.items()})
    finally:
        wp.sample, wp.sample_many = kernel_sample, kernel_many
    grads = {f"{tag}.{n}": p.grad.detach().cpu()
             for tag, net in (("disp", disp), ("pose", pose))
             for n, p in net.named_parameters()}
    return {k: float(v) for k, v in out.items()}, grads


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
    from supervised_dispnet_tpu_torch.models import DispNetS, PoseExpNet

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        B, H, W = MAIN_SHAPE
        rng = np.random.default_rng(6)
        batch = {"tgt": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
                 "ref_imgs": rng.integers(0, 256, (B, 2, H, W, 3), dtype=np.uint8),
                 "intrinsics": np.tile(np.array(KITTI_K, np.float32), (B, 1, 1))}
        base = (DispNetS(generator=torch.Generator().manual_seed(0)),
                PoseExpNet(generator=torch.Generator().manual_seed(1)))

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

    kernels = {**kernel_phase(torch), **warp_phase(torch), **warp_group_phase(torch),
               **ce_phase(torch)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sl = slice_phase(torch, Path(tmp) / "berhu", card)
        ss = selfsup_phase(torch, Path(tmp) / "selfsup", card)
        cl = classification_phase(torch, Path(tmp) / "classification", card)
        cm = classification_phase(torch, Path(tmp) / "multiscale", card, multiscale=True)
    iw = inverse_warp_phase(torch)
    xc = {**cross_check(torch), **selfsup_cross_check(torch)}

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
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
