#!/usr/bin/env python3
"""How far apart the checkpoints of short DispResNet-50 BerHu runs through
``cli.train`` lie on the card: two runs on 1 rank (NCCL) and two on 2 ranks
sharing the card (gloo), each for 1 and for 3 steps at 128x416 with a
global batch of 4, from the same seeded weights on the same seeded packed
split. For each pair (a 1-rank rerun, 2 ranks against 1, a 2-rank rerun)
it prints ``||a - b|| / ||b - theta_0||`` over the whole network, the
encoder and the decoder with the heads (``chip_smoke.py::dispatch_gap``),
and the share of parameters whose update has the other sign. Each run is
``scripts/torch_parallel_run.py`` under ``torch.distributed.run``.

    python3 scripts/torch_parallel_spread.py [--steps 1 3]

Needs one card; the last line is one JSON object. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from supervised_dispnet_tpu_torch.models import get_disp_net  # noqa: E402
from supervised_dispnet_tpu_torch.ops.cuda import _build  # noqa: E402

RUNS = (("1a", 1), ("1b", 1), ("2a", 2), ("2b", 2))
PAIRS = (("1b", "1a"), ("2a", "1a"), ("2b", "2a"))


def launch(n: int, out: Path, cli: list[str]) -> None:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", str(n), "--master-addr", "127.0.0.1", "--master-port",
           str(chip_smoke._free_port()), str(REPO / "scripts" / "torch_parallel_run.py"),
           str(out), "--kinds", "", "--", *cli]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise SystemExit(proc.stdout[-2000:] + proc.stderr[-2000:])


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, nargs="+", default=[1, 3])
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(chip_smoke.card_line(), flush=True)
    _build.build()
    init = dict(get_disp_net("disp_res_50", seed=0, device="cpu").named_parameters())
    names = {"all": list(init), "encoder": [k for k in init if k.startswith("encoder.")],
             "decoder_and_heads": [k for k in init if not k.startswith("encoder.")]}
    report = {"card": chip_smoke.card_line()}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        B, H, W = chip_smoke.MAIN_SHAPE
        chip_smoke.write_packed(tmp / "data", np.random.default_rng(1), H, W)
        for steps in args.steps:
            sds = {}
            for tag, n in RUNS:
                ck = tmp / f"ck{tag}{steps}"
                launch(n, tmp / f"r{tag}{steps}", [
                    str(tmp / "data"), "--network", "disp_res_50", "--loss", "berhu", "-b",
                    str(B), "--epoch-size", str(steps), "--epochs", "1", "--with-gt",
                    "--checkpoints-dir", str(ck), "--name", "p"])
                path = sorted((ck / "p").glob("*/dispnet_checkpoint.pth.tar"))[0]
                sds[tag] = torch.load(path, map_location="cpu", weights_only=True)["state_dict"]
            for a, b in PAIRS:
                gaps = {part: chip_smoke.dispatch_gap(
                    torch, (None, [sds[a][k] for k in ks]),
                    ([init[k].detach() for k in ks], [sds[b][k] for k in ks]))
                    for part, ks in names.items()}
                da = torch.cat([(sds[a][k] - init[k].detach()).flatten() for k in init])
                db = torch.cat([(sds[b][k] - init[k].detach()).flatten() for k in init])
                gaps["sign_differs"] = float(((da * db) < 0).float().mean())
                report[f"steps {steps}: {a} vs {b}"] = gaps
                print(f"steps {steps} {a} vs {b}: " + ", ".join(
                    f"{k} {v:.4g}" for k, v in gaps.items()), flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
