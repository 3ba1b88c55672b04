#!/usr/bin/env python3
"""``chip_smoke.py``'s int8 phase alone on one CUDA card: builds the kernels,
writes the synthetic KITTI-raw tree and a seeded DispResNet-50 checkpoint
(in place of the trained one the whole script has) and runs
``chip_smoke.int8_phase``. Run from the repository root:

    python3 scripts/chip_int8_phase.py [--out results.json]

Prints the int8 conv's kernels-line entry, the card's line and ``OK``;
``--out`` writes all the phase's results as JSON.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the phase's results here (JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_int8_phase: needs one CUDA card", file=sys.stderr)
        return 1
    from supervised_dispnet_tpu_torch.models import get_disp_net
    from supervised_dispnet_tpu_torch.ops.cuda import _build

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    _build.build()
    with tempfile.TemporaryDirectory(prefix="int8_phase_") as tmp:
        tmp = Path(tmp)
        ckpt = tmp / "disp_res_50.pth.tar"
        torch.save({"state_dict": get_disp_net("disp_res_50", seed=3, device="cpu")
                    .state_dict()}, ckpt)
        res, entry = cs.int8_phase(torch, tmp / "int8", card, str(ckpt), cs.kitti_tree(tmp))
    if args.out:
        Path(args.out).write_text(json.dumps({"int8": res, "entry": entry}))
    print(json.dumps(entry))
    print(card)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
