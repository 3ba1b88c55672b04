#!/usr/bin/env python3
"""How far the card's int8 twin of DispResNet-50 lies from the CPU's, over
checkpoints trained as ``chip_smoke.py`` trains its BerHu run, and where the
two part. Run from the repository root:

    python3 scripts/int8_card_vs_cpu.py [--seeds 1 2 3 4 5] [--tree build/parent]

For each of ``--seeds``, a run of 5 BerHu steps through the train CLI on
``chip_smoke.py::write_packed``'s split of that seed (the card's step is
not bit-reproducible, so each run's weights are its own), it builds the
fused and unfused int8 twins as ``chip_smoke.py::int8_networks_phase`` does
(BN statistics of 8 random frames, 99.9th-percentile ranges) and prints the
finest output's relative difference card against CPU at B=1 (p99, max, the
share above 1e-3: what that phase holds) and the same against the CPU twin
fed the card's int8 inputs at each conv (``chip_smoke.py::int8_forced_cpu``:
no moved code spreads; how many codes moved), then, for the unfused twin,
``chip_smoke.py::int8_parting``: whether every int8 conv the card ran
equals the plain version on its own inputs, and where the card's and the
CPU's int8 inputs or residuals first part. ``--tree`` names an unpacked earlier checkout to
compute the same statistics with, on the same checkpoints, in a subprocess.
The last line is the summary's JSON. About a minute of command a checkpoint
on an H100.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def twin_stats(torch, cs, ckpt: str, calls: bool) -> dict:
    """Card against CPU for the fused and unfused twins of ``ckpt``."""
    import numpy as np

    from supervised_dispnet_tpu_torch.cli.test_disp import load_model
    from supervised_dispnet_tpu_torch.ops import quant as pq

    _, H, W = cs.MAIN_SHAPE
    gen = torch.Generator().manual_seed(21)
    frames = (torch.rand(8, H, W, 3, generator=gen) * 2 - 1).to("cuda")
    out = {}
    for fused in (False, True):
        model = load_model(ckpt, "disp_res_50", fused_upsample=fused, device="cuda")
        cs._bn_to_batch(torch, model, frames)
        ranges = pq.calibrate_conv_ranges(model, [frames], percentile=99.9)
        twin = pq.QuantizedModel(model, ranges).to("cuda")
        cpu_twin = pq.QuantizedModel(copy.deepcopy(model).cpu(), ranges)
        with torch.inference_mode():
            want = cpu_twin(frames[:1].cpu())
            got = twin(frames[:1])
        g = (got[0] if isinstance(got, list) else got).float().cpu().numpy()
        w = (want[0] if isinstance(want, list) else want).float().numpy()
        rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-6)
        res = {"median_rel": float(np.median(rel)), "p99_rel": float(np.percentile(rel, 99)),
               "max_rel": float(rel.max()),
               "share_above_1e-3": float((rel > 1e-3).mean())}
        if hasattr(cs, "int8_forced_cpu"):
            forced, parts = cs.int8_forced_cpu(torch, twin, cpu_twin, frames[:1])
            f = (forced[0] if isinstance(forced, list) else forced).float().numpy()
            frel = np.abs(g - f) / np.maximum(np.abs(f), 1e-6)
            res["forced"] = {"median_rel": float(np.median(frel)),
                             "p99_rel": float(np.percentile(frel, 99)),
                             "max_rel": float(frel.max()),
                             "codes_moved": sum(p["differ"] for p in parts),
                             "largest_move": max(p["max"] for p in parts),
                             "residual_max_rel": max((p.get("residual_max_rel", 0.0)
                                                      for p in parts), default=0.0)}
        if calls and not fused:
            res["parting"] = cs.int8_parting(torch, twin, cpu_twin, frames[:1])
        out["fused" if fused else "unfused"] = res
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5],
                    help="the training splits' seeds, one checkpoint each")
    ap.add_argument("--tree", help="an earlier checkout to compute the same statistics with")
    # in the subprocess: a checkpoint's statistics with the checkout at --root
    ap.add_argument("--stats-of", help=argparse.SUPPRESS)
    ap.add_argument("--root", default=str(ROOT), help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from supervised_dispnet_tpu_torch.ops.cuda import _build
    from supervised_dispnet_tpu_torch.utils.device import set_fp32_math

    if not torch.cuda.is_available():
        print("int8_card_vs_cpu: needs one CUDA card", file=sys.stderr)
        return 1
    _build.build()
    set_fp32_math()
    if args.stats_of:
        print(json.dumps(twin_stats(torch, cs, args.stats_of, calls=False)))
        return 0
    from supervised_dispnet_tpu_torch.cli import train as train_cli

    B, H, W = cs.MAIN_SHAPE
    rows = []
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="int8_card_vs_cpu_") as tmp:
            tmp = Path(tmp)
            cs.write_packed(tmp / "data", np.random.default_rng(seed), H, W)
            with contextlib.redirect_stdout(sys.stderr):
                train_cli.main([str(tmp / "data"), "--network", "disp_res_50", "--loss",
                                "berhu", "-b", str(B), "--epoch-size", "5", "--epochs", "1",
                                "--with-gt", "--use-pallas-losses", "--checkpoints-dir",
                                str(tmp / "ckpt"), "--name", "smoke"])
            ckpt = str(sorted((tmp / "ckpt").rglob("dispnet_model_best.pth.tar"))[0])
            row = {"seed": seed, "stats": twin_stats(torch, cs, ckpt, calls=True)}
            if args.tree:
                r = subprocess.run([sys.executable, __file__, "--stats-of", ckpt, "--root",
                                    str(Path(args.tree).resolve())], cwd=args.tree,
                                   capture_output=True, text=True, check=True)
                row["tree_stats"] = json.loads(r.stdout.strip().splitlines()[-1])
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"checkpoints": rows, "card": cs.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
