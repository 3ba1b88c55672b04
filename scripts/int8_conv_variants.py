#!/usr/bin/env python3
"""Device time of the int8 convolution (``csrc/int8_conv.cu``) beside an
earlier ``int8_conv.cu`` given by path, on every distinct int8 conv of the
int8 serving path, on one CUDA card. Run from the repository root:

    git show <commit>:supervised_dispnet_tpu_torch/csrc/int8_conv.cu > build/parent_int8_conv.cu
    python3 scripts/int8_conv_variants.py --parent build/parent_int8_conv.cu [--out r.json]

The parent is the earlier one-phase ``mma.sync`` kernel (its C entry as
that source declares it: 21 dims, a (Cout, Kp) weight padded to 32 taps,
the input's own channels). The convs are those ``chip_smoke.py``'s int8
phase holds: the int8 twins of DispResNet-50 (fused decoder and not) at
(8, 3, 128, 416), FCRN's lhs-dilated unpool convs and DispNetS's
ragged-channel ones, with the phase's seeds. For each conv both builds are
held against the plain version (outputs; the committed build's int32
accumulators bit for bit), then timed in turns, parent, committed,
committed, parent: the device µs of a call (every device event of it,
``torch.profiler`` over 5 calls), beside the bound (``chip_smoke.py::
_int8_bound``). Last, each twin's int8 convs summed over one forward at B=8
(each launch at its conv's mean time), parent against committed. Prints a
line a conv, the sums and, as the last line, one JSON object; the parent's
library goes to ``build/int8_conv_variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

P = ctypes.c_void_p
PARENT_SIGNATURE = [P, P, P, P, P, P, P, ctypes.c_float, ctypes.c_float, ctypes.c_int, P]
PARENT_K_STEP = 32  # the parent's kBK: its weight rows are padded to it
TWINS = (("disp_res_50", True), ("disp_res_50", False), ("dispnet", False), ("fcrn", False))


def build_parent(build, src: Path) -> ctypes.CDLL:
    """Compile the parent source (``nvcc``, the committed flags) and load it."""
    out = REPO / "build" / "int8_conv_variants"
    out.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256(src.read_bytes() + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = out / f"libparent-{h}.so"
    if not lib_path.exists():
        r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent:\n{r.stdout}{r.stderr}")
        print("parent build:", "; ".join(ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                                          if "registers" in ln or "spill" in ln), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.int8_conv.argtypes = PARENT_SIGNATURE
    lib.int8_conv.restype = ctypes.c_int
    return lib


def parent_call(torch, lib, c: cs.Int8Call):
    """A function that launches the parent kernel on ``c``'s conv: the input
    with its own channels, the weight unpacked and padded as the parent
    packs it."""
    from supervised_dispnet_tpu_torch.ops.cuda import int8_conv as ic

    x = c.xq[..., :c.cin].contiguous()
    cout = c.w.shape[0]
    wq = ic.unpack_weight(c.w, c.geom, ic.padded_channels(c.cin))[..., :c.cin].reshape(cout, -1)
    w = torch.nn.functional.pad(wq, (0, -wq.shape[1] % PARENT_K_STEP)).contiguous()
    g, kw = c.geom, c.kw
    B, H, W, C = x.shape
    ho, wo = g.out_hw(H, W)
    out_mode = ic.OUTS[kw.get("out", "f32")]
    res_mode = ic._res_mode(c.residual, kw.get("res_before_bias", False))
    dims = (ctypes.c_int * 21)(B, H, W, C, ho, wo, cout, g.kh, g.kw, *g.stride, g.padding[0],
                               g.padding[2], *g.lhs_dilation, *g.rhs_dilation, w.shape[1],
                               ic.ACTS[kw.get("act", "none")], out_mode, res_mode)
    index = x.get_device()

    def call():
        out = torch.empty((B, ho, wo, cout), dtype=ic.OUT_DTYPES[out_mode], device=x.device)
        code = lib.int8_conv(x.data_ptr(), w.data_ptr(), c.mult.data_ptr(), c.bias.data_ptr(),
                             0 if c.residual is None else c.residual.data_ptr(), out.data_ptr(),
                             dims, float(kw.get("res_scale", 0.0)),
                             float(kw.get("out_scale", 1.0)), index,
                             torch.cuda.current_stream(index).cuda_stream)
        if code != 0:
            raise RuntimeError(f"the parent's int8_conv returned CUDA error {code}")
        return out

    return call


def twin_calls(torch) -> dict:
    """{twin label: the Int8Calls of one forward at (8, 3, 128, 416)}, the
    twins built as ``chip_smoke.py::int8_networks_phase`` builds them."""
    from supervised_dispnet_tpu_torch.ops import quant as pq

    _, H, W = cs.MAIN_SHAPE
    gen = torch.Generator().manual_seed(21)
    x = (torch.rand(8, H, W, 3, generator=gen) * 2 - 1).to(cs.CARD)
    out = {}
    for network, fused in TWINS:
        model = cs._int8_model(torch, network, fused, None)
        cs._bn_to_batch(torch, model, x)
        ranges = pq.calibrate_conv_ranges(model, [x], percentile=99.9)
        twin = pq.QuantizedModel(model, ranges).to(cs.CARD)
        out[f"{network}{'-fused' if fused else ''}"] = cs._record_int8_calls(torch, twin, x)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="an earlier int8_conv.cu")
    ap.add_argument("--out", type=Path, help="write the results here (JSON)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("int8_conv_variants: needs one CUDA card", file=sys.stderr)
        return 1
    from supervised_dispnet_tpu_torch.ops.cuda import _build
    from supervised_dispnet_tpu_torch.ops.cuda import int8_conv as ic
    from supervised_dispnet_tpu_torch.utils.device import set_fp32_math

    set_fp32_math()
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    log = _build.build(["int8_conv"])["int8_conv"]
    print("committed build:", "; ".join(ln.strip() for ln in log.splitlines()
                                        if "registers" in ln or "spill" in ln), flush=True)
    parent = build_parent(_build, args.parent)
    calls = twin_calls(torch)
    picked = calls["disp_res_50-fused"] + calls["disp_res_50"] + \
        [c for c in calls["fcrn"] if c.geom.lhs_dilation == (2, 2)] + \
        [c for c in calls["dispnet"] if c.cin % 4]
    rows, times = [], {}
    for c in picked:
        key = cs.conv_key(c)
        if key in times:
            continue
        new = lambda c=c: ic.int8_conv(c.xq, c.w, c.geom, c.mult, c.bias,  # noqa: E731
                                       residual=c.residual, **c.kw)
        old = parent_call(torch, parent, c)
        want = ic.int8_conv_plain(c.xq, c.w, c.geom, c.mult, c.bias, residual=c.residual,
                                  **c.kw)
        acc = ic.int8_conv(c.xq, c.w, c.geom, c.mult, c.bias, out="s32")
        if not torch.equal(acc, ic.conv_acc_plain(c.xq[..., :c.cin].contiguous(), c.w, c.geom)):
            raise AssertionError(f"{key}: the committed build's accumulators differ")
        got_new, got_old = new(), old()
        torch.cuda.synchronize()
        err = {name: float((g.float() - want.float()).abs().max())
               for name, g in (("committed", got_new), ("parent", got_old))}
        us = {"parent": [], "committed": []}
        for name, fn in (("parent", old), ("committed", new), ("committed", new),
                         ("parent", old)):
            us[name].append(cs.call_device_us(torch, fn))
        bound_ms, by = cs._int8_bound(torch, c, got_new)
        mean = {k: (sum(t for t in v if t is not None) / sum(t is not None for t in v)
                    if any(t is not None for t in v) else None) for k, v in us.items()}
        pl = ic.plan(tuple(c.xq.shape), c.geom, c.w.shape[0])
        row = {"x": [*c.xq.shape[:3], c.cin], "cout": c.w.shape[0], "geom": c.geom.as_list(),
               "epilogue": list(key[4]), "tile": [pl.bm, pl.bn], "splits": pl.splits,
               "phases": len(pl.phases), "device_us": us, "bound_us": bound_ms * 1e3,
               "bound_by": by, "max_abs_err": err, "card": card}
        rows.append(row)
        times[key] = mean

        def share(v):
            return "not measured" if v is None else f"{v:.2f} us ({bound_ms * 1e3 / v:.2%})"

        print(f"x{row['x']} -> {row['cout']} geom {row['geom']} {'/'.join(map(str, key[4]))} "
              f"tile {pl.bm}x{pl.bn} K slices {pl.splits} phases {len(pl.phases)}: parent "
              f"{share(mean['parent'])} [{', '.join(f'{v:.2f}' for v in us['parent'] if v)}], "
              f"committed {share(mean['committed'])} "
              f"[{', '.join(f'{v:.2f}' for v in us['committed'] if v)}]; bound "
              f"{bound_ms * 1e3:.2f} us ({by}); max |diff| parent {err['parent']:g}, committed "
              f"{err['committed']:g}", flush=True)
    sums = {}
    for label, cl in calls.items():
        ts = [times.get(cs.conv_key(c)) for c in cl]
        if any(t is None or None in t.values() for t in ts):
            continue
        sums[label] = {"launches": len(cl), "parent_us": sum(t["parent"] for t in ts),
                       "committed_us": sum(t["committed"] for t in ts)}
        print(f"{label}: {len(cl)} int8 convs a forward at B=8: parent "
              f"{sums[label]['parent_us']:.1f} us, committed {sums[label]['committed_us']:.1f} "
              f"us of device time; on {card}", flush=True)
    slower = [r for r, t in zip(rows, times.values()) if None not in t.values()
              and t["committed"] > t["parent"]]
    print(f"{len(rows)} distinct convs; committed slower than the parent on {len(slower)}",
          flush=True)
    result = {"convs": rows, "forward_sums": sums, "slower": len(slower), "card": card}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result))
    print(json.dumps({"forward_sums": sums, "distinct": len(rows), "slower": len(slower),
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
