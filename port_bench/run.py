"""Run one cell of the benchmark once and print its result line.

    python3 -m port_bench.run --workload ddpg.default --seed 7 --seconds 10 \
        --trace 0

Run from the root of a checkout, on a machine with the cell's CUDA cards.
The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` a `breakdown`, and last `checks`: each number compared with
its limit, also the last lines of standard error. Without CUDA, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded in the
process, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# Kernel and compiler caches at fixed places inside the checkout.
CACHE = os.path.join(ROOT, ".port_bench_cache")
for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(CACHE, sub)


def _write_bytes() -> int | None:
    """Bytes this process and its finished children (the kernels' build)
    sent to storage, or None where the system does not say."""
    try:
        with open("/proc/self/io") as f:
            own = next(int(line.split()[1]) for line in f
                       if line.startswith("write_bytes:"))
    except (OSError, StopIteration):
        return None
    return own + 512 * resource.getrusage(resource.RUSAGE_CHILDREN).ru_oublock


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    try:
        import cartpoleplusplus_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is missing from this checkout: {e}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded in this process: {found}",
              file=sys.stderr)
        return 4
    result["notes"]["write_bytes"] = _write_bytes()
    print(json.dumps(result), flush=True)
    print(json.dumps(result["notes"]), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
