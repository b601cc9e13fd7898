"""Hyperparameter sweep runner (cartpoleplusplus_tpu/sweep.py over the
port's train.main).

Expands a grid spec over train.py flag values, runs each point
in-process (one torch runtime, the CUDA kernels built once for all
points), and appends one JSON line per point to a results file.

Usage:
    python -m cartpoleplusplus_tpu_torch.sweep --out sweep.jsonl \
        --base "--agent dqn --num-envs 256 --total-env-steps 2048" \
        --grid dqn.lr=1e-4,5e-4,1e-3 --grid dqn.gamma=0.95,0.99
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import shlex
import sys
import time


def expand_grid(grid_specs: list[str]) -> list[list[str]]:
    """['k=a,b', 'j=x,y'] -> flag lists for the 4 cartesian points."""
    axes = []
    for spec in grid_specs:
        key, _, values = spec.partition("=")
        if not values:
            raise ValueError(f"bad grid spec {spec!r} (want key=v1,v2,...)")
        flag = "--" + key.replace("_", "-")
        axes.append([(flag, v) for v in values.split(",")])
    return [[tok for pair in point for tok in pair]
            for point in itertools.product(*axes)]


def run_sweep(base: list[str], grid_specs: list[str], out_path: str) -> int:
    from .train import main as train_main

    points = expand_grid(grid_specs) if grid_specs else [[]]
    with open(out_path, "a") as out:
        for i, extra in enumerate(points):
            argv = base + extra
            t0 = time.time()
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    rc = train_main(argv)
                lines = [json.loads(l) for l in buf.getvalue().splitlines()
                         if l.startswith("{")]
                final = lines[-1] if lines else {}
                record = {"point": i, "argv": argv, "rc": rc,
                          "seconds": round(time.time() - t0, 2),
                          "final": final}
            except Exception as e:  # record, keep sweeping
                record = {"point": i, "argv": argv, "rc": -1,
                          "error": f"{type(e).__name__}: {e}"}
            out.write(json.dumps(record) + "\n")
            out.flush()
            print(f"[{i + 1}/{len(points)}] {' '.join(extra) or '(base)'} "
                  f"-> rc={record['rc']}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cartpoleplusplus_tpu_torch.sweep",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--base", default="",
                    help="flags shared by every point (quoted string)")
    ap.add_argument("--grid", action="append", default=[],
                    help="key=v1,v2,... (repeatable; cartesian product)")
    ap.add_argument("--out", required=True, help="results .jsonl path")
    args = ap.parse_args(argv)
    return run_sweep(shlex.split(args.base), args.grid, args.out)


if __name__ == "__main__":
    sys.exit(main())
