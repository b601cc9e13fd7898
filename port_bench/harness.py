"""One run of one cell: set-up, the measured window, the per-layer reading
of a traced window, and the comparison that decides `correct`.

Everything that belongs to a cell is found by name: the cell's entry in
BENCHMARK.json names its configuration (`configs/<config>.json`) and its
traffic (`traffic/<traffic>.json`); its limits are `limits/<cell>.json`;
the configuration names its driver (`drivers/<driver>.py`: what the window
drives, its set-up, its plain reference and the numbers compared), its
agent's reference (`reference/<agent>.py`), its kernels
(`roofline/<kernel>.py`: operations and bytes) and the hooks of its host
spans and faults (hooks.py); each metric is read by `metrics/<name>.py`,
by the part of its name before the first dot.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from . import trace

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# Top-level module names that no run may hold: JAX, its libraries and the
# JAX package that the program is a port of.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "cartpoleplusplus_tpu")
# Host-clock span of the host-cost reading after a traced window.
HOST_READ_S = 0.3


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict

    @property
    def agent(self) -> str:
        return self.config["agent"]

    @property
    def settings(self) -> dict:
        """The agent's configuration with the traffic's overrides."""
        return {**self.config["agent_config"], **self.traffic["agent_config"]}

    @property
    def num_envs(self) -> int:
        return self.traffic["num_envs"]

    @property
    def driver(self):
        """`drivers/<driver>.py` of the configuration."""
        return importlib.import_module(
            f"port_bench.drivers.{self.config['driver']}")


def load_cell(name: str, overrides: dict | None = None,
              root: str = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json, its files under
    `root`/port_bench; `overrides` ({"num_envs": n, "agent_config": {...}})
    resize it for tests."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    files = os.path.join(root, os.path.basename(BENCH))
    traffic = _json(os.path.join(files, "traffic", entry["traffic"] + ".json"))
    if overrides:
        traffic = {**traffic, **overrides, "agent_config": {
            **traffic["agent_config"], **overrides.get("agent_config", {})}}
    return Cell(name=name,
                config=_json(os.path.join(files, "configs",
                                          entry["config"] + ".json")),
                traffic=traffic, chips=entry["chips"],
                limits=_json(os.path.join(files, "limits", name + ".json")))


def reader(metric: str):
    """The reader of a metric: `metrics/<name>.py`, by the part of the
    metric's name before its first dot (`step_mfu.host_paced` is read by
    `metrics/step_mfu.py`)."""
    return importlib.import_module(
        f"port_bench.metrics.{metric.split('.')[0]}")


def cell_metrics(bench: dict, group: str, cell: str) -> list:
    """The names of the metrics of `group` ("end_to_end" or "per_layer")
    that the cell reports."""
    return [m["name"] for m in bench[group]
            if cell in m.get("workloads", [cell])]


def full_precision() -> None:
    """float32 products everywhere, as the training CLI sets them on a
    CUDA device: no TF32, no reduced-precision bfloat16 sums."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Marks:
    """One time mark after each train step: a CUDA event on the card's
    timeline, the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list:
        pairs = zip(self.marks[:-1], self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def window(step, state, seconds: float, device, marks=None):
    """Train steps back to back until the host clock passes `seconds`,
    between two synchronizes: (state, steps, window seconds)."""
    _sync(device)
    t0 = time.perf_counter()
    if marks is not None:
        marks.mark()
    n = 0
    while time.perf_counter() - t0 < seconds:
        state, _ = step(state)
        n += 1
        if marks is not None:
            marks.mark()
    _sync(device)
    return state, n, time.perf_counter() - t0


def host_ms_per_step(step, state, device):
    """The host's own cost of a train step: each step started on an idle
    card, the host clock around the call alone, until the calls add up to
    HOST_READ_S. (state, mean ms)."""
    total, n = 0.0, 0
    while total < HOST_READ_S:
        _sync(device)
        t = time.perf_counter()
        state, _ = step(state)
        total += time.perf_counter() - t
        n += 1
    _sync(device)
    return state, total / n * 1e3


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""

    cell: Cell
    steps: int
    trace: trace.Trace | None
    host_ms_per_step: float | None
    notes: dict


def read_metrics(names: list, ctx: Context) -> dict:
    out = {}
    for name in names:
        value = reader(name).read(ctx)
        if value is not None:
            out[name] = value
    return out


def _traced(cell: Cell, agent, step, state, seconds: float, device,
            notes: dict, wanted: list):
    """The traced window, then the host's cost per step: (state, steps,
    the per-layer metrics in `wanted` that their readers find, the Trace
    or None off the card)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with trace.spans(agent, cell.config.get("spans", {})):
        prof = profile(activities=acts)
        prof.start()
        with record_function(trace.WINDOW):
            state, steps, window_s = window(step, state, seconds, device)
        t = time.perf_counter()
        prof.stop()
    notes["profiler_stop_s"] = time.perf_counter() - t
    t = time.perf_counter()
    tr = trace.read(prof, window_s) if device.type == "cuda" else None
    notes["trace_read_s"] = time.perf_counter() - t
    if tr is not None:
        notes["device_kinds"] = tr.device_kinds
    state, host_ms = host_ms_per_step(step, state, device)
    return state, steps, read_metrics(
        wanted, Context(cell, steps, tr, host_ms, notes)), tr


def judge(values: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): correct when every number that
    the cell's limits name is finite and within its limit."""
    rows = [(n, values[n], lim) for n, lim in limits.items()]
    return all(v == v and v <= lim for _, v, lim in rows), rows


def run(name: str, seed: int, seconds: float, traced: bool, device,
        t_start: float, overrides: dict | None = None,
        fault: str | None = None, precision: str | None = None,
        root: str = ROOT) -> dict:
    """One run of the cell `name`: the result line's object. For tests,
    `fault` plants one of faults.FAULTS in the train step, `precision` sets
    the learner's product precision and `root` holds the BENCHMARK.json
    and the cell's files."""
    cell = load_cell(name, overrides, root)
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    drv = cell.driver
    full_precision()
    agent, step = drv.build(cell, device, precision, fault)
    state, prog, init, notes = drv.setup(cell, agent, step, seed, device)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    if traced:
        state, steps, metrics_out, tr = _traced(
            cell, agent, step, state, seconds, device, notes,
            cell_metrics(bench, "per_layer", name))
    else:
        marks = _Marks(device)
        state, steps, window_s = window(step, state, seconds, device, marks)
        step_ms = marks.step_ms()
        notes["step_ms_median"] = statistics.median(step_ms)
        readings = {
            "env_steps_per_s": steps * drv.work_per_step(cell) / window_s,
            "step_ms_p95": float(np.percentile(step_ms, 95)),
            "setup_s": setup_s}
        # An end-to-end metric is its reading's name, or that name with a
        # suffix after a dot for the cells it is kept apart for.
        metrics_out = {m: readings[m.split(".")[0]]
                       for m in cell_metrics(bench, "end_to_end", name)}
        tr = None

    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    del state, agent, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = drv.reference(cell, seed, init, device)
    notes["reference_s"] = time.perf_counter() - t
    values = drv.numbers(prog, ref, init)
    correct, rows = judge(values, cell.limits)
    notes.update({k: v for k, v in values.items() if k not in cell.limits})
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    result = {
        "correct": correct, "attempted": steps, "failed": 0,
        "metrics": {k: {"value": v, "unit": units[k]}
                    for k, v in metrics_out.items()},
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1, "memory_peak_bytes": peak},
        "notes": notes,
    }
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = trace.breakdown(tr)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result


def forbidden_modules() -> list:
    """The modules in this process whose top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
