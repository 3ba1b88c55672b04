#!/usr/bin/env python3
"""Device time of the grouped BerHu forward (``csrc/berhu.cu``) built with
other grid and register-cache choices, on one CUDA card. Run from the
repository root:

    python3 scripts/berhu_forward_variants.py

The kernel sizes its cooperative grid to hold ``kCacheItems`` elements a
thread in registers across its grid barriers ("cached, grid by items") and
reads the elements again only where the co-resident grid cannot hold them.
This script compiles copies of the source with one of those choices
changed:
  - reread, grid by items: pass B always reads the elements again;
  - cached / reread, all co-resident: the grid is every block that fits
    on the card at once, capped by one block a 256 elements;
  - cached / reread, 132 blocks: one block an SM.
For each, at the supervised step's group (4 predictions of (4, 128, 416))
and at (4, 256, 832), it prints the forward's device time a launch
(``torch.profiler``, 100 launches, twice) and whether the count and c of
every problem have the same bits as the committed kernel's. Copies and
libraries go to ``build/berhu_variants/``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CACHED = "const bool cached = n <= stride * kCacheItems;"
GRID = "const long work = (n + kThreads * kCacheItems - 1) / (kThreads * kCacheItems);"
REREAD = "const bool cached = false;"
CORESIDENT = "const long work = (n + kThreads - 1) / kThreads;"
SMS = "const long work = 132;"
VARIANTS = {
    "reread, grid by items": ((CACHED, REREAD),),
    "cached, all co-resident": ((GRID, CORESIDENT),),
    "reread, all co-resident": ((CACHED, REREAD), (GRID, CORESIDENT)),
    "cached, 132 blocks": ((GRID, SMS),),
    "reread, 132 blocks": ((CACHED, REREAD), (GRID, SMS)),
}


def build_variants(build, source: str, out: Path) -> dict[str, ctypes.CDLL]:
    """Compile each variant's copy of the source (one ``nvcc`` each, all
    started together) and load it with the wrappers' signatures."""
    from supervised_dispnet_tpu_torch.ops.cuda import losses as kl

    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"csrc/berhu.cu no longer has {old!r}: update {__file__}")
            text = text.replace(old, new)
        src, lib = out / f"berhu_v{k}.cu", out / f"libberhu_v{k}.so"
        src.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in kl._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.berhu_error_string.argtypes = [ctypes.c_int]
        lib.berhu_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("berhu_forward_variants: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from supervised_dispnet_tpu_torch.ops.cuda import _build
    from supervised_dispnet_tpu_torch.ops.cuda import losses as kl

    print(cs.card_line(), flush=True)
    _build.build(["berhu"])
    libs = {"cached, grid by items (committed)": kl._lib(),
            **build_variants(_build, (_build.CSRC / "berhu.cu").read_text(),
                             REPO / "build" / "berhu_variants")}
    kernel = "berhu_forward_group_kernel"
    rng = np.random.default_rng(0)
    try:
        for shape in (cs.MAIN_SHAPE, (4, 256, 832)):
            preds, gt, mask = cs._berhu_group(torch, rng, shape, 4)
            ref = None
            for name, lib in libs.items():
                _build._libs["berhu"] = lib
                out = kl.berhu_forward_many(preds, gt, mask, cs.STEP_WEIGHTS)
                ref = out.clone() if ref is None else ref
                same = torch.equal(out[:12].view(4, 3)[:, 1:], ref[:12].view(4, 3)[:, 1:])
                us = [cs.device_us(torch, lambda: kl.berhu_forward_many(
                    preds, gt, mask, cs.STEP_WEIGHTS), (kernel,), reps=100)[kernel][0]
                      for _ in range(2)]
                print(f"  {shape} {name}: device us a launch {us[0]:.3f} / {us[1]:.3f}; "
                      f"count and c bit-equal to the committed kernel's: {same}", flush=True)
    finally:
        _build._libs["berhu"] = libs["cached, grid by items (committed)"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
