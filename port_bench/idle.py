"""Where the card idles in a cell's train steps, by the program's host
spans: a window of train steps under torch.profiler, as a traced run's,
with each idle stretch of the card put down to the innermost `cp.*` span
(cartpoleplusplus_tpu_torch/utils/spans.py) that the host was in.

    python3 -m port_bench.idle --workload ddpg.default --seed 7 --seconds 10

Prints one JSON object: the window's train steps, seconds and busy
seconds, and per train step `idle_ms_by_span` (idle milliseconds by
innermost span; OUTSIDE where the host was in none), `host_ms_by_span`
(each span's host milliseconds, from the profiler's events) and
`spans_per_step`. The benchmark's own wrappers (trace.spans) are left out,
so only the program's spans name the time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import trace

T_START = time.perf_counter()
OUTSIDE = "outside cp spans"
PREFIX = "cp."


def innermost(spans) -> list:
    """[(start, end, name)]: properly nested spans cut so that each instant
    lies in the innermost span that covers it, in order; instants in no
    span are left out."""
    out, stack, t = [], [], None

    def close(end, name):
        nonlocal t
        if end > t:
            out.append((t, end, name))
            t = end

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            close(*stack.pop())
        if stack and s > t:
            out.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    while stack:
        close(*stack.pop())
    return out


def idle_by_span(spans, busy, window) -> dict:
    """{span name: idle time}: each stretch of `window` (lo, hi) outside
    the merged, sorted `busy` intervals, put down to the innermost of
    `spans` ([(start, end, name)]) over it, and to OUTSIDE where none
    covers it."""
    lo, hi = window
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    segs, out, j = innermost(spans), {}, 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        covered, k = 0, j
        while k < len(segs) and segs[k][0] < b:
            s, e, name = segs[k]
            d = min(b, e) - max(a, s)
            if d > 0:
                out[name] = out.get(name, 0) + d
                covered += d
            k += 1
        if b - a > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0) + (b - a - covered)
    return out


def read(prof, steps: int) -> dict:
    """The window's reading (see the module's docstring) from a profile
    whose train steps ran inside a trace.WINDOW span."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, device, win = [], [], None
    for e in prof.profiler.kineto_results.events():
        name, kind = e.name(), trace._kind(e)
        s = e.start_ns()
        end = s + e.duration_ns()
        if kind in trace.DEVICE_WORK:
            device.append((s, end))
        elif name == trace.WINDOW and kind == "user_annotation":
            win = (s, end)
        elif name.startswith(PREFIX) and e.device_type() != cuda:
            spans.append((s, end, name))
    if win is None:
        raise RuntimeError("the trace holds no window span")
    spans = [x for x in spans if win[0] <= x[0] < win[1]]
    busy = trace._union(device, *win)
    per = 1e-6 / max(steps, 1)
    host, counts = {}, {}
    for s, e, name in spans:
        host[name] = host.get(name, 0) + (e - s) * per
        counts[name] = counts.get(name, 0) + 1
    idle = idle_by_span(spans, busy, win)
    return {
        "steps": steps, "window_s": (win[1] - win[0]) * 1e-9,
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "idle_ms_by_span": {k: v * per for k, v in sorted(idle.items())},
        "host_ms_by_span": dict(sorted(host.items())),
        "spans_per_step": {k: v / max(steps, 1)
                           for k, v in sorted(counts.items())}}


def measure(name: str, seed: int, seconds: float, device,
            overrides: dict | None = None) -> dict:
    """Set the cell up as a run does and read one profiled window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import harness

    cell = harness.load_cell(name, overrides)
    drv = cell.driver
    harness.full_precision()
    agent, step = drv.build(cell, device)
    state, _, _, _ = drv.setup(cell, agent, step, seed, device)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    with record_function(trace.WINDOW):
        state, steps, _ = harness.window(step, state, seconds, device)
    prof.stop()
    out = read(prof, steps)
    if device.type == "cuda":
        out["device"] = torch.cuda.get_device_name(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench.idle",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the reading is of the card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = measure(args.workload, args.seed, args.seconds, device)
    out["setup_and_window_s"] = time.perf_counter() - T_START
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
