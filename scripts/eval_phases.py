#!/usr/bin/env python3
"""``chip_smoke.py``'s eval and inference phases alone, on one CUDA card,
with seeded DispResNet-50 checkpoints in place of the training phases'.
Run from the repository root:

    python3 scripts/eval_phases.py

It writes the synthetic KITTI-raw tree (2 drives of 8 frames at
375x1242), evaluates a seeded disparity checkpoint with
``cli.test_disp.main`` on the card, on the CPU, with ``--fused-upsample``
and a seeded classification checkpoint with ``--classification``, runs
``cli.run_inference.main`` on one drive's frames, and times the eval
forward unfused and fused (``chip_smoke.py::eval_phase``,
``inference_phase``, ``eval_forward_timing``), with the same checks. Every
kernel counter is set to 0 before and printed after: these paths launch
none. The last line is the phases' JSON. About a minute of command on an
H100, a quicker check of the eval path than the whole smoke script.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from supervised_dispnet_tpu_torch.models import get_disp_net  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("eval_phases: needs one CUDA card", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    with tempfile.TemporaryDirectory(prefix="eval_phases_") as tmp:
        tmp = Path(tmp)
        ckpt, class_ckpt = tmp / "disp.pth.tar", tmp / "classification.pth.tar"
        torch.save({"state_dict": get_disp_net("disp_res_50", seed=1,
                                               device="cpu").state_dict()}, ckpt)
        torch.save({"state_dict": get_disp_net("disp_res_50", head="classification", seed=2,
                                               device="cpu").state_dict()}, class_ckpt)
        for mod, attr in cs.kernel_counters():
            setattr(mod, attr, 0)
        tree = cs.kitti_tree(tmp)
        ev = cs.eval_phase(torch, tmp, card, tree, str(ckpt), str(class_ckpt))
        inf = cs.inference_phase(torch, tmp, tree, str(ckpt))
        launches = {attr: getattr(mod, attr) for mod, attr in cs.kernel_counters()}
    print(json.dumps({"eval": ev, "inference": inf, "eval_kernel_launches": launches}))
    return 1 if any(launches.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
