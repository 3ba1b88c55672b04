#!/usr/bin/env python3
"""Device time of the CE forward and backward (``csrc/ce.cu``) built with
other block sizes, bins a fold or a compiled K, and of an earlier ``ce.cu``
given by path, on one CUDA card. Run from the repository root:

    python3 scripts/ce_variants.py [--parent path/to/an/earlier/ce.cu]

The committed kernels take ``kThreads`` threads a block, fold ``kChunk``
bins at a time (that many loads in flight a thread) and know K only at run
time. This script compiles copies of the source with one of those constants
changed, with K fixed at 64 when compiled (right only at the shape the
script runs), with the fold loops unrolled by 2 (the next fold's loads may
start before this fold's arithmetic), or without the streaming cache hints
on the 16-byte accesses, and, with
``--parent``, compiles the one-pixel-a-thread design that the committed
kernels replaced: a partial-sum kernel plus a final-reduce kernel forward,
a backward that reads each logit three times (its C entries as that source
declares them). At the main path's shape, (4, 128, 416, 64) in the
NCHW-view layout with a one-byte ~10% mask, it prints for each build the
device time of the forward (all its kernels) and of the backward a call
(``torch.profiler``, 100 calls, the whole set twice), the share of the
bound (``chip_smoke.py::ce_bounds``), and how far its loss and gradient are
from the committed build's. A profile in which a kernel does not show one
event a call, or another device event shows, is taken again, up to three
times; the build's time is then reported as not measured. Copies and
libraries go to ``build/ce_variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
COMMITTED = "256 threads, 8-bin folds, K at run time, streaming hints (committed)"
THREADS = "constexpr int kThreads = 256;"
CHUNK = "constexpr int kChunk = 8;"
FOLD_LOOP = "#pragma unroll 1\n    for (; k0 + kChunk <= K; k0 += kChunk) fold_bins"
GRAD_LOOP = "#pragma unroll 1\n        for (; k0 + kChunk <= K; k0 += kChunk) {"
LOAD = "const float4 q = __ldcs(reinterpret_cast<const float4*>(p));"
STORE = "__stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));"
# name: (text in csrc/ce.cu, its replacement) pairs
VARIANTS = {
    "128 threads, 8-bin folds": ((THREADS, "constexpr int kThreads = 128;"),),
    "512 threads, 8-bin folds": ((THREADS, "constexpr int kThreads = 512;"),),
    "256 threads, 4-bin folds": ((CHUNK, "constexpr int kChunk = 4;"),),
    "256 threads, 16-bin folds": ((CHUNK, "constexpr int kChunk = 16;"),),
    "256 threads, 32-bin folds": ((CHUNK, "constexpr int kChunk = 32;"),),
    "K = 64 compiled": (("row_stats<L>(logits + lay.row(i), lay.sk, lay.K, y)",
                         "row_stats<L>(logits + lay.row(i), lay.sk, 64, y)"),
                        ("    const int K = lay.K;\n", "    const int K = 64;\n")),
    "fold loops unrolled by 2": ((FOLD_LOOP, FOLD_LOOP.replace("unroll 1", "unroll 2")),
                                 (GRAD_LOOP, GRAD_LOOP.replace("unroll 1", "unroll 2"))),
    "no cache hints on the 16-byte loads and stores": (
        (LOAD, "const float4 q = *reinterpret_cast<const float4*>(p);"),
        (STORE, "*reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);")),
}
PARENT = "parent (one pixel a thread, 2 kernels forward)"
_P, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
# the earlier design's C entries
PARENT_SIGNATURES = {
    "ce_forward": [_P, _P, _P, _I, _L, _L, _I, _L, _L, _L, _I, _P, _P, _I, _P],
    "ce_backward": [_P, _P, _P, _I, _L, _L, _I, _L, _L, _L, _P, _P, _P, _I, _P],
}


def build_all(build, parent: Path | None) -> dict[str, ctypes.CDLL]:
    """Compile every variant (one ``nvcc`` each, all started together) and
    load it with its entries' signatures."""
    from supervised_dispnet_tpu_torch.ops.cuda import classification as kc

    out = REPO / "build" / "ce_variants"
    out.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "ce.cu").read_text()
    jobs = {}
    for k, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"csrc/ce.cu no longer has {old!r}: update {__file__}")
            text = text.replace(old, new)
        src = out / f"ce_v{k}.cu"
        src.write_text(text)
        jobs[name] = (src, kc._SIGNATURES)
    if parent is not None:
        jobs[PARENT] = (parent, PARENT_SIGNATURES)
    procs = {}
    for k, (name, (src, _)) in enumerate(jobs.items()):
        lib = out / f"libce_v{k}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = "; ".join(ln.strip() for ln in log.splitlines() if "registers" in ln)
        print(f"  built {name}: {regs}", flush=True)
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in jobs[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.ce_error_string.argtypes = [ctypes.c_int]
        lib.ce_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def parent_calls(torch, lib, logits, labels, mask, g):
    """The earlier design's forward and backward calls on these inputs,
    through its C entries (its grid: one pixel a thread, at most 1,024
    blocks for the partial sums)."""
    from supervised_dispnet_tpu_torch.ops.cuda import _build
    from supervised_dispnet_tpu_torch.ops.cuda import classification as kc

    mask, mask_is_float = kc._check_inputs(logits, labels, mask)
    logits, shape = kc.kernel_layout(logits)
    dev = logits.device
    nblocks = max(1, min(1024, -(-labels.numel() // 256)))
    scratch = torch.empty(2 * nblocks, device=dev)
    stats = torch.empty(2, device=dev)
    dlogits = torch.empty_like(logits)
    inputs = (logits.data_ptr(), labels.data_ptr(), mask.data_ptr(), int(mask_is_float), *shape)

    def fwd():
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib, "ce", "ce_forward", lib.ce_forward(
            *inputs, nblocks, scratch.data_ptr(), stats.data_ptr(), dev.index, stream))
        return stats

    def bwd():
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib, "ce", "ce_backward", lib.ce_backward(
            *inputs, stats.data_ptr(), g.data_ptr(), dlogits.data_ptr(), dev.index, stream))
        return dlogits

    return fwd, bwd


def call_us(torch, cs, fn, kernels: tuple, tries: int = 3) -> tuple:
    """Device µs of one call of ``fn``: the sum of its kernels' times a
    launch, from a profile of 100 calls in which each kernel rounds to one
    event a call and no other device event shows (the profiler can drop
    events: 29 of 100 in one earlier reading). Such a profile is taken up to
    ``tries`` times; then (None, the last profile's counts)."""
    for _ in range(tries):
        got = cs.device_us(torch, fn, [*kernels, ""], reps=100)
        every = got.pop("")[1]
        counts = [n for _, n in got.values()]
        if all(round(n) == 1 for n in counts) and abs(every - sum(counts)) < 1e-9:
            return sum(t for t, _ in got.values()), got
        print(f"    the profile shows {got} of {every:g} device events a call; again",
              flush=True)
    return None, got


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="an earlier ce.cu to time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ce_variants: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from supervised_dispnet_tpu_torch.ops.cuda import _build
    from supervised_dispnet_tpu_torch.ops.cuda import classification as kc

    card = cs.card_line()
    print(card, flush=True)
    _build.build(["ce"])
    libs = {COMMITTED: kc._lib(), **build_all(_build, args.parent)}
    logits, labels, mask = cs._ce_case(torch, np.random.default_rng(7), cs.MAIN_SHAPE, 64)
    g = torch.tensor(0.7, device="cuda")
    N, K = labels.numel(), logits.shape[-1]
    bound_us = {k: v[0] * 1e3 for k, v in zip(("fwd", "bwd"), cs.ce_bounds(N, K).values())}
    stats, lse = kc.ce_forward(logits, labels, mask)
    ref_loss, ref_grad = stats[0].clone(), kc.ce_backward(logits, labels, mask, lse, stats, g)
    report = {"card": card, "shape": [*cs.MAIN_SHAPE, K], "bound_us": bound_us, "runs": []}
    try:
        for run in range(2):
            for name, lib in libs.items():
                if name == PARENT:
                    fwd, bwd = parent_calls(torch, lib, logits, labels, mask, g)
                    names = {"fwd": ("ce_sum_kernel", "ce_final_kernel"),
                             "bwd": ("ce_bwd_kernel",)}
                else:
                    _build._libs["ce"] = lib
                    st, ls = kc.ce_forward(logits, labels, mask)

                    def fwd():
                        return kc.ce_forward(logits, labels, mask)[0]

                    def bwd(st=st, ls=ls):
                        return kc.ce_backward(logits, labels, mask, ls, st, g)

                    names = {"fwd": ("ce_forward_kernel",), "bwd": ("ce_backward_kernel",)}
                loss = fwd()[0].clone()
                grad = bwd()
                errs = {"loss": float((loss - ref_loss).abs()),
                        "grad": float((grad - ref_grad).abs().max())}
                us, said = {}, []
                for key, fn in (("fwd", fwd), ("bwd", bwd)):
                    us[key], got = call_us(torch, cs, fn, names[key])
                    us[f"{key}_kernels"] = {k: list(v) for k, v in got.items()}
                    said.append("not measured" if us[key] is None else
                                f"{us[key]:.2f} us ({bound_us[key] / us[key]:.1%} of the bound)")
                report["runs"].append({"run": run, "build": name, "device_us": us,
                                       "abs_err_vs_committed": errs})
                print(f"  run {run} {name}: forward {said[0]}, backward {said[1]}; loss abs "
                      f"err {errs['loss']:.3g}, grad max abs err {errs['grad']:.3g} against "
                      f"the committed build", flush=True)
    finally:
        _build._libs["ce"] = libs[COMMITTED]
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
