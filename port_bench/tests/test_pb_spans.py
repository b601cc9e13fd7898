"""The readers of the program's own spans and counters, and the idle
reading by span, on the CPU: on a profiled window of a tiny cell the span
readers give positive milliseconds per train step, and nothing without a
traced window or with a program that keeps no spans; the library's reader
reads its counters; each idle stretch goes to its innermost span."""

from __future__ import annotations

import collections
import json
import os
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from port_bench import harness, idle, trace

CELLS = ("ddpg.default", "dqn.suite")
SPANS = ("presample_ms", "launch_prep_ms", "host_wait_ms")
NEW = {"presample_ms": "program_span", "launch_prep_ms": "program_span",
       "host_wait_ms": "program_span", "library_s": "program_counter"}
BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
SEED = 2 ** 31 + 7
CPU = torch.device("cpu")


def small(cell: str) -> dict:
    """The cell at 64 envs and (32, 32) nets, its cadence kept short; the
    learner at "kernel", whose plain twin runs on the CPU."""
    return {"num_envs": 64, "agent_config": {
        "hidden": [32, 32], "batch_size": 32, "updates_per_step": 2,
        "replay_capacity_per_env": 64, "learner": "kernel"}}


@pytest.fixture
def fresh(monkeypatch):
    """The program's span totals, from zero."""
    from cartpoleplusplus_tpu_torch.utils.spans import span

    monkeypatch.setattr(span, "seconds", collections.Counter())
    monkeypatch.setattr(span, "counts", collections.Counter())
    return span


def _traced_window(cell: str):
    c = harness.load_cell(cell, small(cell))
    agent, step = c.driver.build(c, CPU)
    state, _, _, _ = c.driver.setup(c, agent, step, SEED, CPU)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            state, steps, window_s = harness.window(step, state, 0.3, CPU)
    return c, steps, trace.read(prof, window_s)


@pytest.mark.parametrize("cell", CELLS)
def test_the_span_readers_read_a_traced_window(cell, fresh):
    c, steps, tr = _traced_window(cell)
    ctx = harness.Context(c, steps, tr, None, {})
    got = {m: harness.reader(m).read(ctx) for m in SPANS}
    assert all(v > 0 for v in got.values()), got
    assert fresh.counts["cp.train_step"] == steps
    ms = ctx.notes["span_ms_per_step"]
    assert got["presample_ms"] + got["launch_prep_ms"] <= ms["cp.train_step"]
    assert ctx.notes["spans_per_step"]["cp.wait.indices"] == 1.0
    untraced = harness.Context(c, steps, None, None, {})
    assert all(harness.reader(m).read(untraced) is None for m in SPANS)


def test_a_program_without_spans_gives_nothing_to_read(fresh, monkeypatch):
    c = harness.load_cell(CELLS[0])
    ctx = harness.Context(c, 10, object(), None, {})
    fresh.seconds["cp.replay.presample"] = 0.01
    fresh.counts["cp.replay.presample"] = 10
    assert harness.reader("presample_ms").read(ctx) == pytest.approx(1.0)
    assert harness.reader("host_wait_ms").read(ctx) is None
    monkeypatch.setitem(sys.modules, "cartpoleplusplus_tpu_torch.utils.spans",
                        None)
    assert all(harness.reader(m).read(ctx) is None for m in SPANS)


def test_the_library_reader_reads_the_programs_counters(monkeypatch):
    from cartpoleplusplus_tpu_torch.ops._native import load_library

    ctx = harness.Context(harness.load_cell(CELLS[0]), 1, None, None, {})
    monkeypatch.setattr(load_library, "load_s", 0.0)
    assert harness.reader("library_s").read(ctx) is None
    monkeypatch.setattr(load_library, "build_s", 1.5)
    monkeypatch.setattr(load_library, "load_s", 0.25)
    monkeypatch.setattr(load_library, "builds", 1)
    assert harness.reader("library_s").read(ctx) == 1.75
    assert ctx.notes == {"library_build_s": 1.5, "library_load_s": 0.25,
                         "library_builds": 1}
    monkeypatch.delattr(load_library, "load_s")
    assert harness.reader("library_s").read(ctx) is None


def test_the_new_metrics_resolve_to_their_readers():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name, source in NEW.items():
        named = [n for n in entries if n.split(".")[0] == name]
        assert named and callable(harness.reader(name).read)
        for n in named:
            assert entries[n]["source"] == source and entries[n]["workloads"]
            assert callable(harness.reader(n).read)


def test_each_idle_stretch_goes_to_its_innermost_span():
    spans = [(5, 95, "cp.train_step"), (5, 20, "cp.rollout"),
             (30, 90, "cp.learner"), (35, 55, "cp.wait.indices"),
             (56, 58, "cp.prep.B3")]
    assert idle.innermost(spans) == [
        (5, 20, "cp.rollout"), (20, 30, "cp.train_step"),
        (30, 35, "cp.learner"), (35, 55, "cp.wait.indices"),
        (55, 56, "cp.learner"), (56, 58, "cp.prep.B3"),
        (58, 90, "cp.learner"), (90, 95, "cp.train_step")]
    got = idle.idle_by_span(spans, [(0, 10), (50, 60)], (0, 100))
    assert got == {"cp.rollout": 10, "cp.train_step": 15,
                   "cp.learner": 35, "cp.wait.indices": 15,
                   idle.OUTSIDE: 5}
    assert idle.idle_by_span([], [(0, 100)], (0, 100)) == {}


def test_an_idle_reading_of_a_cpu_window_lies_in_the_spans():
    """Off the card nothing is busy, so the whole window is idle; the
    train steps' spans cover almost all of it."""
    t = time.perf_counter()
    out = idle.measure("ddpg.default", SEED, 0.3, CPU, small("ddpg.default"))
    assert time.perf_counter() - t < 120
    per_step = out["window_s"] * 1e3 / out["steps"]
    assert sum(out["idle_ms_by_span"].values()) == pytest.approx(per_step)
    inside = per_step - out["idle_ms_by_span"].get(idle.OUTSIDE, 0.0)
    assert inside >= 0.9 * per_step
    assert out["spans_per_step"]["cp.train_step"] == 1.0
    assert out["host_ms_by_span"]["cp.train_step"] <= per_step
