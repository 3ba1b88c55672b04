#!/usr/bin/env python3
"""Device time of the image+coordinate warp backward (``csrc/warp.cu::
warp_backward_kernel``) built with other tiles, windows, flushes and
thresholds, and of an earlier ``warp.cu`` given by path, on one CUDA card.
Run from the repository root:

    python3 scripts/warp_bwd_variants.py [--parent path/to/an/earlier/warp.cu]

The committed kernel covers a 2-D tile of ``kTilePixels`` output pixels a
block (``kTilePixelsPerThread`` a thread; the tile's width from
``ops/cuda/warp.py::tile_plan``). A block whose 32 sample pixels hold fewer
than ``kDenseSamples`` window candidates adds every corner straight to dimg
in one pass; in the others a warp with at least ``kDenseLanes`` candidates
whose corners' box has more than ``kSpread`` image pixels a pixel gathers
its image gradient in a shared window of ``kWinFloats`` floats (clipped
where at least ``kMinHits`` corners a window pixel land in it), flushed with
atomicAdds of ``kFlushWidth`` floats into a dimg that ``cudaMemsetAsync``
zeroed. This script compiles copies of the source with one of those
constants changed, with no edge-pile merging, with dimg zeroed by a
kernel of float4 stores in place of the memset, or stopped early (before
the window's barrier, before the flush: where the time goes; their dimg
is wrong and only their times count), and calls the committed build with
a wider tile; with ``--parent`` it compiles the
one-thread-a-pixel design that the committed kernel replaced (12 global
atomics a pixel, its C entry as that source declares it). At the main
path's shape, (4, 128, 416, 3), on five kinds of coordinates
(``chip_smoke.py::_warp_case``: a random per-pixel depth's projection, a
road scene's, the road with 5% near points thrown far, the road in border
mode with its piles on the edges, random coordinates mostly out of bounds)
it prints for each build the device time of the kernel and of the zeroing
a call (``torch.profiler``, 100 calls, the whole set twice, the second time
in the reverse order), the share of the bound, and how far dimg, dx and dy
are from the committed build's. A profile in which an item does not show
one event a call, or another device event shows, is taken again, up to
three times; the time is then reported as not measured. Copies and
libraries go to ``build/warp_bwd_variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
COMMITTED = ("committed (32x8 tiles, 1 px a thread, 48 KB window, float4 flush, 0.125 hits; "
             "window block >= 24 of 32 samples, window warp >= 16 lanes, > 2 box pixels a pixel)")
PARENT = "parent (one thread a pixel, 12 global atomics a pixel)"
PER_THREAD = "constexpr int kTilePixelsPerThread = 1;"
WINDOW = "constexpr int kWinFloats = 12 * 1024 - 96;"
MIN_HITS = "constexpr float kMinHits = 0.125f;"
SAMPLES = "constexpr int kDenseSamples = 24;"
DENSE = "constexpr int kDenseLanes = 16;"
SPREAD = "constexpr float kSpread = 2.0f;"
MEMSET = ("    err = cudaMemsetAsync(dimg, 0, sizeof(float) * B * static_cast<size_t>(H) * W * C,"
          " s);\n    if (err != cudaSuccess) return err;\n")
ZERO_KERNEL = '''__global__ void zero_dimg_kernel(float4* __restrict__ p, long n4) {
    for (long v = blockIdx.x * static_cast<long>(kThreads) + threadIdx.x; v < n4;
         v += static_cast<long>(gridDim.x) * kThreads) {
        p[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
}

bool bad_shape('''
ZERO_LAUNCH = '''    {  // a float count that is a multiple of 4 at a 16-byte address here
        const long n4 = B * static_cast<long>(H) * W * C / 4;
        const long blocks = n4 / kThreads + 1;
        zero_dimg_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), kThreads, 0,
                           s>>>(reinterpret_cast<float4*>(dimg), n4);
    }
'''
BARRIER = "    if ((threadIdx.x & 31) == 0) {\n        const int w = threadIdx.x >> 5;\n"
STOP = "    if (H != -7) return;  // always: the compiler keeps the code after it\n"
# name: ((text in csrc/warp.cu, its replacement) pairs, tile_plan arguments, tile_w)
VARIANTS = {
    "tiles 64 wide x 4": ((), {}, 64),
    "2 px a thread (32x16 tiles)": (((PER_THREAD, PER_THREAD.replace("1", "2")),),
                                    {"tile_pixels": 512}, None),
    "4 px a thread (32x32 tiles)": (((PER_THREAD, PER_THREAD.replace("1", "4")),),
                                    {"tile_pixels": 1024}, None),
    "24 KB window": (((WINDOW, WINDOW.replace("12 * 1024", "6 * 1024")),),
                     {"win_floats": 6 * 1024 - 96}, None),
    "float2 flush": ((("constexpr int kFlushWidth = 4;", "constexpr int kFlushWidth = 2;"),),
                     {}, None),
    "scalar flush": ((("constexpr int kFlushWidth = 4;", "constexpr int kFlushWidth = 1;"),),
                     {}, None),
    **{f"a clipped window kept at {v} hits a pixel": (
        ((MIN_HITS, MIN_HITS.replace("0.125f", f"{v}f")),), {}, None)
       for v in ("0.0", "0.25", "1.0")},
    **{f"a window block needs {v} of its 32 samples": (
        ((SAMPLES, SAMPLES.replace("24", str(v))),), {}, None) for v in (0, 8, 16)},
    **{f"window pixels need {v} of a warp's lanes": (
        ((DENSE, DENSE.replace("16", str(v))),), {}, None) for v in (1, 8, 24)},
    **{f"a window warp's box has > {v} pixels a pixel": (
        ((SPREAD, SPREAD.replace("2.0f", f"{v}f")),), {}, None)
       for v in ("0.0", "1.0", "4.0", "8.0")},
    "no window warp (every corner to dimg)": (((SPREAD, SPREAD.replace("2.0f", "3e38f")),), {},
                                              None),
    "no merging of a pile's clamped corners": (
        (("if (border && q.x1 == q.x0)", "if (false)"),
         ("if (border && q.y1 == q.y0)", "if (false)")), {}, None),
    "dimg zeroed by a kernel, not cudaMemsetAsync": (
        (("bool bad_shape(", ZERO_KERNEL), (MEMSET, ZERO_LAUNCH)), {}, None),
    # where the time goes: the kernel stopped early (dimg wrong; times only)
    "timing only: stopped before the window's barrier": (
        ((BARRIER, STOP + BARRIER),), {}, None),
    "timing only: stopped before the flush": ((
        ("    if (!shared_path) return;\n    __syncthreads();",
         STOP + "    if (!shared_path) return;\n    __syncthreads();"),), {}, None),
}
CASES = {  # name: (_warp_case coords, padding mode)
    "projection zeros": ("projection", "zeros"),
    "road zeros": ("road", "zeros"),
    "road near points zeros": ("road_near", "zeros"),
    "road border (piles)": ("road", "border"),
    "random out of bounds zeros": ("random", "zeros"),
}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the earlier design's C entry: img, x, y, g, dimg, dx, dy, B, H, W, C, P, border, device, stream
PARENT_SIGNATURE = [_P] * 7 + [_I] * 4 + [ctypes.c_long, _I, _I, _P]


def build_all(build, kw, parent: Path | None) -> dict[str, ctypes.CDLL]:
    """Compile every variant (one ``nvcc`` each, all started together) and
    load it with its entry's signature."""
    out = REPO / "build" / "warp_bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "warp.cu").read_text()
    jobs = {}
    for k, (name, (edits, _, _)) in enumerate(VARIANTS.items()):
        if not edits:
            continue
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"csrc/warp.cu no longer has {old!r}: update {__file__}")
            text = text.replace(old, new)
        src = out / f"warp_v{k}.cu"
        src.write_text(text)
        jobs[name] = (src, kw._SIGNATURES["warp_backward"])
    if parent is not None:
        jobs[PARENT] = (parent, PARENT_SIGNATURE)
    procs = {}
    for k, (name, (src, _)) in enumerate(jobs.items()):
        lib = out / f"libwarp_v{k}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(f"  built {name}: {kernel_registers(log)}", flush=True)
        lib = ctypes.CDLL(str(path))
        lib.warp_backward.argtypes = jobs[name][1]
        lib.warp_backward.restype = ctypes.c_int
        lib.warp_error_string.argtypes = [ctypes.c_int]
        lib.warp_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def kernel_registers(log: str, kernel: str = "warp_backward_kernel") -> str:
    """What ``nvcc -Xptxas=-v`` said of ``kernel``: its spills and its
    registers and shared memory, the lines after the one that names it."""
    said, on = [], False
    for ln in log.splitlines():
        on = on or (kernel in ln and "Compiling entry" in ln)
        if on and ("spill" in ln or "Used" in ln):
            said.append(ln.strip())
            if "Used" in ln:
                break
    return "; ".join(said)


def backward_call(torch, lib, name: str, img, x, y, g, mode: str):
    """A function that runs this build's image+coordinate backward on these
    inputs through its C entry and returns (dimg, dx, dy)."""
    from supervised_dispnet_tpu_torch.ops.cuda import _build
    from supervised_dispnet_tpu_torch.ops.cuda import warp as kw

    B, H, W, C = img.shape
    Ho, Wo = x.shape[1:]
    dimg, dx, dy = torch.empty_like(img), torch.empty_like(x), torch.empty_like(y)
    ptrs = [t.data_ptr() for t in (img, x, y, g, dimg, dx, dy)]
    border, dev = int(mode == "border"), img.device
    if name == PARENT:
        shape = (B, H, W, C, Ho * Wo)
    else:
        _, plan, tile_w = VARIANTS.get(name, ((), {}, None))
        tw, _, win_w = kw.tile_plan(Ho, Wo, C, **plan)
        shape = (B, H, W, C, Ho, Wo, tile_w or tw, win_w)

    def call():
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib, "warp", "warp_backward",
                     lib.warp_backward(*ptrs, *shape, border, dev.index, stream))
        return dimg, dx, dy

    return call


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="an earlier warp.cu to time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("warp_bwd_variants: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from supervised_dispnet_tpu_torch.ops.cuda import _build
    from supervised_dispnet_tpu_torch.ops.cuda import warp as kw

    card = cs.card_line()
    print(card, flush=True)
    log = _build.build(["warp"])["warp"]
    print(f"  built {COMMITTED}: {kernel_registers(log) or 'already built'}", flush=True)
    libs = {COMMITTED: kw._lib(), **{n: kw._lib() for n, v in VARIANTS.items() if not v[0]},
            **build_all(_build, kw, args.parent)}
    B, H, W = cs.MAIN_SHAPE
    rng = np.random.default_rng(11)
    cases = {name: (cs._warp_case(torch, rng, (B, H, W, 3), coords, seed=20 + k), mode)
             for k, (name, (coords, mode)) in enumerate(CASES.items())}
    n_img, P = B * H * W * 3, B * H * W
    bound_us = cs.bound_ms(4 * (2 * n_img + 4 * P + 3 * P), P * (20 + 22 * 3))[0] * 1e3
    refs = {name: [t.clone() for t in backward_call(torch, libs[COMMITTED], COMMITTED,
                                                    *inputs, mode)()]
            for name, (inputs, mode) in cases.items()}
    report = {"card": card, "shape": [B, H, W, 3], "bound_us": bound_us, "runs": []}
    order = list(libs)
    for run in range(2):
        for name in order if run == 0 else order[::-1]:
            zero = "zero_dimg_kernel" if name.startswith("dimg zeroed") else "Memset"
            for case, (inputs, mode) in cases.items():
                call = backward_call(torch, libs[name], name, *inputs, mode)
                got = call()
                torch.cuda.synchronize()
                errs = [float((a - b).abs().max()) for a, b in zip(got, refs[case])]
                us = None
                for _ in range(3):
                    d = cs.device_us(torch, call, ["warp_backward_kernel", zero, ""], reps=100)
                    every = d.pop("")[1]
                    if (all(round(n) == 1 for _, n in d.values())
                            and abs(every - sum(n for _, n in d.values())) < 1e-9):
                        us = {"kernel": d["warp_backward_kernel"][0], "zero": d[zero][0]}
                        break
                    print(f"    the profile shows {d} of {every:g} device events a call; "
                          "again", flush=True)
                report["runs"].append({"run": run, "build": name, "case": case,
                                       "device_us": us, "max_abs_err_vs_committed": errs})
                said = ("not measured" if us is None else
                        f"kernel {us['kernel']:.2f} us ({bound_us / us['kernel']:.1%} of the "
                        f"bound) + zeroing {us['zero']:.2f} us")
                print(f"  run {run} {name} | {case}: {said}; max abs err against the "
                      f"committed build dimg {errs[0]:.3g}, dx {errs[1]:.3g}, dy {errs[2]:.3g}",
                      flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
