"""What a traced window holds, read from torch.profiler's events: the
device's busy intervals (kernels, copies and sets), each device operation's
time by the name the profiler gives it, and the longest idle gaps with the
host operation that covered each.

Host spans from the benchmark's own wrappers (`spans`, at the hooks that
the cell's configuration names) mark the layers the train step calls
into, so that an idle gap reads as "what the host was doing": the
innermost host event that covers the gap's middle.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from . import hooks

WINDOW = "port_bench.window"
# The profiler's activity types that occupy the device.
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset", "concurrent_kernel")
TOP = 10
# The breakdown keeps the head of a device operation's name: its kernel and
# template arguments, not the whole parameter list.
NAME_CHARS = 120


@dataclasses.dataclass
class Trace:
    window_s: float       # the traced window, host clock sync to sync
    busy_s: float         # the union of the device's work in it
    ops: dict             # device operation name -> [seconds, count]
    gaps: list            # [[host operation, seconds]], longest first
    device_kinds: list    # the activity types seen on the device


def _union(intervals, lo: int, hi: int) -> list:
    """Merged intervals clipped to [lo, hi], sorted."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _kind(e) -> str:
    """The profiler's activity type of an event; torch builds whose events
    do not name it are read from the device and the annotation flag."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    if e.is_user_annotation():
        return ("gpu_user_annotation"
                if e.device_type() == torch.autograd.DeviceType.CUDA
                else "user_annotation")
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return "cuda_sync" if "Sync" in e.name() else "kernel"
    return "cpu_op"


def read(prof, window_s: float) -> Trace:
    """The Trace of a profile whose window ran inside a WINDOW span."""
    host, device, win, kinds = [], [], None, set()
    for e in prof.profiler.kineto_results.events():
        name, kind = e.name(), _kind(e)
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kinds.add(kind if kind != "kernel" or name.startswith("void")
                      else name[:40])
        if kind in DEVICE_WORK:
            device.append((s, end, name))
        elif name == WINDOW and kind == "user_annotation":
            win = (s, end)
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append((s, end, name))
    if win is None:
        raise RuntimeError("the trace holds no window span")
    busy = _union([(s, e) for s, e, _ in device], *win)
    ops = {}
    for s, e, name in device:
        if win[0] <= s < win[1]:
            acc = ops.setdefault(name, [0.0, 0])
            acc[0] += (e - s) * 1e-9
            acc[1] += 1
    edges = [win[0]] + [x for iv in busy for x in iv] + [win[1]]
    idle = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)), reverse=True)[:TOP]
    gaps = []
    for length, start in idle:
        mid = start + length // 2
        cover = [(e - s, name) for s, e, name in host
                 if s <= mid < e and name != WINDOW]
        gaps.append([min(cover)[1] if cover else "no host operation",
                     length * 1e-9])
    return Trace(window_s=window_s,
                 busy_s=sum(e - s for s, e in busy) * 1e-9, ops=ops,
                 gaps=gaps, device_kinds=sorted(kinds))


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time and the longest idle
    gaps, TOP of each, as the result line carries them."""
    ops = sorted(((v[0], k) for k, v in trace.ops.items()), reverse=True)
    return {"device_ops": [[k[:NAME_CHARS], s] for s, k in ops[:TOP]],
            "idle_gaps": trace.gaps}


@contextlib.contextmanager
def spans(agent, hooks_by_span: dict):
    """Host spans around the calls a train step makes into each layer:
    `hooks_by_span` maps a span name to a hook (hooks.py: a target on the
    agent or a module of the program, and the function on it), as the
    cell's configuration lists them. Each wrapper shares its function's
    attribute dict, so counters the program keeps on a function still
    count; every attribute is restored on exit."""
    from torch.profiler import record_function

    def wrap(name, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        spanned.__dict__ = fn.__dict__
        return spanned

    saved = []
    try:
        for name, (target, attr) in hooks_by_span.items():
            obj = hooks.resolve(agent, target)
            fn = getattr(obj, attr)
            saved.append((obj, attr, vars(obj).get(attr)))
            setattr(obj, attr, wrap(name, fn))
        yield
    finally:
        for obj, attr, old in reversed(saved):
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)
