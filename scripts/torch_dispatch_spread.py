#!/usr/bin/env python3
"""How far runs of the same self-supervised steps part on one CUDA card, and
how far ``--steps-per-dispatch`` lies from single steps. Run from the
repository root:

    python3 scripts/torch_dispatch_spread.py [--runs 4] [--cudnn-deterministic]

DispNetS + PoseExpNet from the seeded weights of
``chip_smoke.py::_dispatch_run``, on its smoke split (``--loader device``,
the main path's batch and size): ``--runs`` runs of 4 single steps,
``--runs - 1`` runs of one block of 4 steps, and one run of 3 single steps,
which stands for a dispatch that loses a step. For every pair it prints
``chip_smoke.py::dispatch_gap`` (the distance between the two runs'
parameters as a share of how far the steps moved them), the relative L2
distance over all parameters and the largest over single tensors. The card's
step is not bit-reproducible, so the single runs part by a random amount:
this is what ``chip_smoke.py``'s limit on the block's gap is set from. The
last line is the summary's JSON. Under half a minute of command on an H100.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def distances(run, ref) -> dict:
    flat = [torch.cat([p.flatten() for p in ps]) for ps in (run[1], ref[1])]
    per = [cs._rel_l2(x, y) for x, y in zip(run[1], ref[1])]
    return {"gap_over_movement": cs.dispatch_gap(torch, run, ref),
            "rel_l2": cs._rel_l2(flat[0], flat[1]), "tensor_rel_l2_max": max(per)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=4, help="runs of 4 single steps")
    ap.add_argument("--cudnn-deterministic", action="store_true",
                    help="torch.backends.cudnn.deterministic on, benchmark off")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dispatch_spread: needs one CUDA card", file=sys.stderr)
        return 1
    from supervised_dispnet_tpu_torch.ops.cuda import _build

    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    _build.build()
    if args.cudnn_deterministic:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    _, H, W = cs.MAIN_SHAPE
    with tempfile.TemporaryDirectory(prefix="dispatch_spread_") as tmp:
        tmp = Path(tmp)
        cs.write_packed(tmp / "data", np.random.default_rng(33), H, W, with_depth=False)
        singles = [cs._dispatch_run(torch, tmp / "data", tmp / f"k1_{n}", 1)
                   for n in range(args.runs)]
        blocks = [cs._dispatch_run(torch, tmp / "data", tmp / f"k4_{n}", 4)
                  for n in range(args.runs - 1)]
        short = cs._dispatch_run(torch, tmp / "data", tmp / "k1_short", 1, steps=3)
    pairs = {"single_vs_single": [distances(a, b) for a, b in itertools.combinations(singles, 2)],
             "block_vs_single": [distances(a, b) for a in blocks for b in singles],
             "3_steps_vs_4": [distances(short, b) for b in singles]}
    for name, rows in pairs.items():
        for row in rows:
            print(f"  {name}: {row}", flush=True)
    summary = {name: {key: [min(r[key] for r in rows), max(r[key] for r in rows)]
                      for key in rows[0]} for name, rows in pairs.items()}
    summary["cudnn_deterministic"] = args.cudnn_deterministic
    summary["card"] = card
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
