"""The readings that the limits of `correct` are set from, at a cell's own
size: the program's numbers on many seeds (the lower readings), the
control's (the program's own bfloat16 learner products, the nearest
precision below the configuration's float32) and the planted faults' (the
upper readings). No measured window: the numbers come from set-up's first
learning steps and the reference.

    python3 -m port_bench.control --workload ddpg.default --seeds 12 \
        --first-seed 1000 --variants program bfloat16 half_batch

prints one JSON line per variant and seed, then per variant the largest
and smallest reading of each number. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from . import harness
from .faults import FAULTS, applicable

VARIANTS = ("program", "bfloat16") + tuple(FAULTS)


def readings(name: str, seeds: list, variants: list, device,
             overrides: dict | None = None) -> dict:
    """{variant: [numbers per seed]}."""
    cell = harness.load_cell(name, overrides)
    drv = cell.driver
    harness.full_precision()
    refs = {}
    for seed in seeds:
        init = drv.initial_weights(cell, seed, device)
        refs[seed] = (init, drv.reference(cell, seed, init, device))
    out = {}
    for variant in variants:
        if variant in FAULTS and variant not in applicable(cell):
            continue
        agent, step = drv.build(
            cell, device, "bfloat16" if variant == "bfloat16" else None,
            variant if variant in FAULTS else None)
        rows = []
        for seed in seeds:
            init, ref = refs[seed]
            state, prog, _, _ = drv.setup(cell, agent, step, seed, device,
                                          warm=False)
            del state
            rows.append(drv.numbers(prog, ref, init))
            print(json.dumps({"cell": name, "variant": variant, "seed": seed,
                              **rows[-1]}), flush=True)
        out[variant] = rows
        del agent, step
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench.control",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=1000)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    out = readings(args.workload, seeds, args.variants, device)
    for variant, rows in out.items():
        print(json.dumps({"cell": args.workload, "variant": variant,
                          "max": {n: max(r[n] for r in rows)
                                  for n in rows[0]},
                          "min": {n: min(r[n] for r in rows)
                                  for n in rows[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
