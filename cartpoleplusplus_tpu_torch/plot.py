"""Training-curve plots from train and sweep JSON logs
(cartpoleplusplus_tpu/plot.py, the port's copy; matplotlib, Agg).

Usage:
    python -m cartpoleplusplus_tpu_torch.train --agent dqn ... > run.jsonl
    python -m cartpoleplusplus_tpu_torch.plot run.jsonl --out curves.png
    python -m cartpoleplusplus_tpu_torch.plot sweep.jsonl --sweep \
        --key final.reward_mean
"""

from __future__ import annotations

import argparse
import json
import sys


def load_jsonl(path: str) -> list[dict]:
    with open(path) as fh:
        return [json.loads(l) for l in fh if l.strip().startswith("{")]


def _get(d: dict, dotted: str):
    for part in dotted.split("."):
        d = d[part]
    return d


def plot_run(records, keys, out):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs = [r.get("env_steps", i) for i, r in enumerate(records)]
    fig, axes = plt.subplots(len(keys), 1, figsize=(7, 2.4 * len(keys)),
                             sharex=True, squeeze=False)
    for ax, key in zip(axes[:, 0], keys):
        ys = [r.get(key) for r in records]
        ax.plot(xs, ys, lw=1.2)
        ax.set_ylabel(key)
        ax.grid(True, alpha=0.3)
    axes[-1, 0].set_xlabel("env steps (per env)")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    return out


def plot_sweep(records, key, out):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = [" ".join(r["argv"][-4:]) for r in records]
    values = [(_get(r, key) if r.get("rc") == 0 else float("nan"))
              for r in records]
    fig, ax = plt.subplots(figsize=(7, 0.5 * len(records) + 1.5))
    ax.barh(range(len(records)), values)
    ax.set_yticks(range(len(records)), labels, fontsize=7)
    ax.set_xlabel(key)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cartpoleplusplus_tpu_torch.plot",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("log", help="train stdout .jsonl or sweep results")
    ap.add_argument("--out", default="curves.png")
    ap.add_argument("--keys", nargs="*",
                    default=["reward_mean", "done_frac"],
                    help="metrics to plot (train mode)")
    ap.add_argument("--sweep", action="store_true",
                    help="treat input as sweep results")
    ap.add_argument("--key", default="final.reward_mean",
                    help="dotted metric for sweep bars")
    args = ap.parse_args(argv)
    records = load_jsonl(args.log)
    if not records:
        print("no JSON records found", file=sys.stderr)
        return 1
    if args.sweep:
        out = plot_sweep(records, args.key, args.out)
    else:
        out = plot_run(records, args.keys, args.out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
