"""Operations and bytes of the program's kernels, counted from a cell's
shapes, and the share of its roofline that a kernel reached in a traced
window. `roofline/<kernel>.py` gives one kernel's `KERNEL` (the device
function's name as the profiler shows it), `counts(cell)` (float
operations and bytes of one launch: each input byte read once, each output
byte written once) and `net_flop(cell)` (the network FLOPs it computes per
train step, for the step's share of the peak)."""

from __future__ import annotations

import importlib

from .peaks import bound


def kernel(name: str):
    return importlib.import_module(f"port_bench.roofline.{name}")


def share(ctx, name: str):
    """100 x the kernel's bound over its mean device time per launch in the
    traced window, or None where the cell runs no such kernel or the trace
    holds none of its launches."""
    if ctx.trace is None or name not in ctx.cell.config["kernels"]:
        return None
    k = kernel(name)
    runs = [v for op, v in ctx.trace.ops.items() if k.KERNEL in op]
    launches = sum(c for _, c in runs)
    if not launches:
        return None
    seconds, bound_by = bound(*k.counts(ctx.cell))
    ctx.notes[f"{name}_bound_by"] = bound_by
    ctx.notes[f"{name}_bound_ms"] = seconds * 1e3
    ctx.notes[f"{name}_ms_per_launch"] = (sum(s for s, _ in runs) / launches
                                          * 1e3)
    return 100.0 * seconds * launches / sum(s for s, _ in runs)
