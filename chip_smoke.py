#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``supervised_dispnet_tpu_torch``) on one
CUDA card. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. print the card's name and power limit; build every CUDA kernel from
     ``supervised_dispnet_tpu_torch/csrc`` (timed);
  2. kernels: the BerHu kernel, forward and backward, against its plain
     PyTorch version on the card at the main-path shape, ragged shapes, an
     all-masked-out case and an all-quadratic case; CUDA-event timings;
  3. slice: supervised BerHu training of DispResNet-50 at 128x416, B=4,
     through ``cli.train.main`` on a packed split written here, with
     validation against GT and ``Trainer.predict``; the kernels' launch
     counts over that run; the steady-state step time and a profile of the
     device time by kernel;
  4. cross-check: one train step from identical weights on one batch, TF32
     off: the card with the kernel against the card with the plain BerHu,
     and against the CPU with the plain BerHu;
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
                mask_dtype="bool"):
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
    dev = torch.device("cuda")
    return (torch.from_numpy(pred).to(dev), torch.from_numpy(gt).to(dev),
            torch.from_numpy(mask).to(dev))


def kernel_phase(torch) -> dict:
    """BerHu kernel vs plain version. Tolerances: loss rtol 1e-5, gradient
    rtol 1e-5 / atol 1e-7; they differ only in summation order."""
    from supervised_dispnet_tpu_torch.losses.supervised import berhu_loss_plain
    from supervised_dispnet_tpu_torch.ops.cuda import losses as kl

    rng = np.random.default_rng(0)
    cases = {
        "main (4,128,416)": _berhu_case(torch, rng, MAIN_SHAPE),
        "ragged (3,37,53)": _berhu_case(torch, rng, (3, 37, 53)),
        "ragged (3,37,53) float mask": _berhu_case(torch, rng, (3, 37, 53),
                                                   mask_dtype="float32"),
        "ragged (3,37,53) fractional mask": _berhu_case(torch, rng, (3, 37, 53),
                                                        mask_dtype="fractional"),
        "ragged (1,1,7)": _berhu_case(torch, rng, (1, 1, 7), mask_kind="all"),
        "all masked out (4,128,416)": _berhu_case(torch, rng, MAIN_SHAPE,
                                                  mask_kind="none"),
        "every |d| > c (3,37,53)": _berhu_case(torch, rng, (3, 37, 53),
                                               mask_kind="all", quadratic=True),
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
    if stats0[:2] != [0.0, 0.0] or not math.isclose(stats0[2], 1e-6, rel_tol=1e-6):
        raise AssertionError(f"all-masked-out stats {stats0} != [0, 0, 1e-6]")

    pred, gt, mask = cases["main (4,128,416)"]
    n = pred.numel()
    p_req = pred.clone().requires_grad_(True)
    plain_loss = berhu_loss_plain(p_req, gt, mask)
    stats = kl.berhu_forward_stats(pred, gt, mask)
    g = torch.ones((), device=pred.device)
    t = {
        "fwd": cuda_ms(torch, lambda: kl.berhu_forward_stats(pred, gt, mask)),
        "fwd_plain": cuda_ms(torch, lambda: berhu_loss_plain(pred, gt, mask)),
        "bwd": cuda_ms(torch, lambda: kl.berhu_backward(pred, gt, mask, stats, g)),
        "bwd_plain": cuda_ms(torch, lambda: torch.autograd.grad(
            plain_loss, p_req, retain_graph=True)),
    }
    # the least the function must move: each input read once, each output
    # written once (pred, gt f32; mask 1 byte); ~10 flops/px fwd, ~6 bwd
    fwd_bound, fwd_by = bound_ms(9 * n + 12, 10 * n)
    bwd_bound, bwd_by = bound_ms(9 * n + 12 + 4 * n, 6 * n)
    print(f"  berhu main path: fwd kernel_ms {t['fwd']:.5f} plain_ms "
          f"{t['fwd_plain']:.5f} bound_us {fwd_bound * 1e3:.3f}; bwd kernel_ms "
          f"{t['bwd']:.5f} plain_ms {t['bwd_plain']:.5f} bound_us "
          f"{bwd_bound * 1e3:.3f}; library_ms null", flush=True)
    src = "supervised_dispnet_tpu_torch/csrc/berhu.cu"
    return {
        "berhu_fwd": {"name": "berhu_fwd", "route": "cuda", "source": src,
                      "replaces": f"{TPU_KERNEL}:203", "max_abs_err": err_fwd,
                      "ms": t["fwd"], "plain_ms": t["fwd_plain"],
                      "bound_ms": fwd_bound, "bound_by": fwd_by,
                      "library_ms": None},
        "berhu_bwd": {"name": "berhu_bwd", "route": "cuda", "source": src,
                      "replaces": f"{TPU_KERNEL}:238", "max_abs_err": err_bwd,
                      "ms": t["bwd"], "plain_ms": t["bwd_plain"],
                      "bound_ms": bwd_bound, "bound_by": bwd_by,
                      "library_ms": None},
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
                 n_val: int = 8) -> None:
    """A tiny packed dataset: random frames, ~10% sparse GT depth, two
    scenes per split, KITTI-like intrinsics."""
    from supervised_dispnet_tpu_torch.data.packed import write_split

    K = np.array([[241.7, 0.0, W / 2], [0.0, 246.3, H / 2], [0.0, 0.0, 1.0]],
                 np.float32)
    for split, n in (("train", n_train), ("val", n_val)):
        images = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
        depth = rng.uniform(1.0, 80.0, (n, H, W)) * (rng.uniform(size=(n, H, W)) < 0.1)
        write_split(root / split, images, np.stack([K, K]),
                    [(0, n // 2), (n // 2, n)], depth.astype(np.float32))


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
    kl.berhu_fwd_launches = kl.berhu_bwd_launches = 0
    with contextlib.redirect_stdout(tee):
        trainer = train_cli.main(argv)
    torch.cuda.synchronize()
    launches = {"berhu_fwd": kl.berhu_fwd_launches, "berhu_bwd": kl.berhu_bwd_launches}
    steps = trainer.step
    print(f"  slice: {steps} steps; launches {launches}", flush=True)
    if steps < 5 or any(v != 4 * steps for v in launches.values()):
        raise AssertionError(f"expected 4 BerHu launches per step each way over "
                             f"{steps} steps, got {launches}")
    text = tee.buf.getvalue()
    if "abs_rel=" not in text or "rmse=" not in text:
        raise AssertionError("validation printed no abs_rel / rmse")
    events = [json.loads(line) for line in
              (Path(trainer.cfg.save_path) / "metrics.jsonl").read_text().splitlines()]
    losses = [e["loss"] for e in events if e["event"] == "train_iter"]
    epoch = [e for e in events if e["event"] == "epoch"][0]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train losses not finite: {losses}")
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

    # steady state: the same step as the CLI ran, timed after warm-up
    train_loader, _ = trainer.make_loaders()
    batches = iter(train_loader)
    batch = trainer.prep_train_batch(next(batches))
    batches.close()  # stops the loader's prefetch thread
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"  slice step: DispResNet-50 {H}x{W} B={B} fp32 BerHu train step "
          f"{step_ms:.3f} ms, {B / step_ms * 1e3:.1f} img/s on {card}",
          flush=True)
    return {"launches": launches, "step_ms": step_ms, "train_losses": losses,
            "val": {k: epoch[k] for k in ("abs_rel", "rmse", "a1")},
            "profile": profile_steps(torch, lambda: trainer.train_step(batch))}


def profile_steps(torch, step, n: int = 5, top: int = 12) -> dict:
    """Device time of ``n`` steps by kernel, from ``torch.profiler``: the
    busy share of the steps' wall time and the ``top`` kernels by total
    device time."""
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
    rows = [{"kernel": e.key[:90], "calls_per_step": e.count / n,
             "ms_per_step": e.self_device_time_total / n / 1e3} for e in kernels[:top]]
    print(f"  profile over {n} steps: device busy {busy_us / n / 1e3:.3f} ms of "
          f"{wall_us / n / 1e3:.3f} ms a step ({busy_us / wall_us:.1%}); "
          f"{len(kernels)} kernels", flush=True)
    for r in rows:
        print(f"    {r['ms_per_step']:8.3f} ms  x{r['calls_per_step']:<5g} {r['kernel']}",
              flush=True)
    return {"steps": n, "wall_ms_per_step": wall_us / n / 1e3,
            "busy_ms_per_step": busy_us / n / 1e3, "top": rows}


def _grads_agree(g, ref, rtol: float = 1e-3) -> tuple[bool, float]:
    """|g - ref| <= rtol * |ref| + rtol * max|ref| elementwise; also returns
    the worst excess over that bound, relative to max|ref|."""
    scale = max(float(ref.abs().max()), 1e-30)
    excess = (g - ref).abs() - rtol * ref.abs()
    return bool((excess <= rtol * scale).all()), float(excess.max()) / scale


def _rel_l2(g, ref) -> float:
    return float((g - ref).norm() / ref.norm().clamp(min=1e-30))


def _one_step(torch, model, batch: dict, device, plain: bool = False):
    """One supervised BerHu train step, augmentation off; ``plain=True``
    swaps the plain BerHu in for the kernel. Returns (loss, {name: grad}
    on the CPU)."""
    from supervised_dispnet_tpu_torch.data.augment import AugmentConfig
    from supervised_dispnet_tpu_torch.losses.supervised import berhu_loss_plain
    from supervised_dispnet_tpu_torch.training import train_step as ts

    no_aug = AugmentConfig(flip=False, scale_crop=False, color_jitter=False)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    kernel_loss = ts.SUPERVISED_LOSSES["berhu"]
    if plain:
        ts.SUPERVISED_LOSSES["berhu"] = berhu_loss_plain
    try:
        step = ts.make_supervised_train_step(model, opt, "berhu", aug=no_aug)
    finally:
        ts.SUPERVISED_LOSSES["berhu"] = kernel_loss
    loss = step({k: torch.from_numpy(v).to(device) for k, v in batch.items()})["loss"]
    return float(loss), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def cross_check(torch, device: str = "cuda") -> dict:
    """One train step at the main-path shape from identical weights on one
    batch, augmentation off, TF32 off for cuDNN and matmul. Loss rtol 1e-4;
    gradients rtol 1e-3 (``_grads_agree``: the two sides sum in other
    orders).

    - DispResNet-50 on the card, with the kernel against the plain BerHu:
      the same convolutions on the same device, so every gradient must
      agree and only the loss kernel differs.
    - DispResNet-50 and -18, card (kernel) against CPU (plain): the loss and
      the decoder's and heads' gradients. The encoder's gradients are
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
        for depth_n, plain_dev, other in ((50, device, "card plain"), (50, "cpu", "cpu"),
                                          (18, "cpu", "cpu")):
            base = DispResNet(depth_n, generator=torch.Generator().manual_seed(3))
            l_a, g_a = _one_step(torch, copy.deepcopy(base).to(device), batch, device)
            l_b, g_b = _one_step(torch, copy.deepcopy(base).to(plain_dev), batch, plain_dev,
                                 plain=True)
            tag = f"DispResNet-{depth_n} card vs {other}"
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

    kernels = kernel_phase(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sl = slice_phase(torch, Path(tmp), card)
    xc = cross_check(torch)

    for name, entry in kernels.items():
        entry["launches"] = sl["launches"][name]
    print(json.dumps({"slice": {"step_ms": sl["step_ms"], "card": card,
                                "val": sl["val"], "profile": sl["profile"]},
                      "cross_check": xc}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
