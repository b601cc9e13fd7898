"""A whole run of each cell at a size a test run holds, on the CPU: the
look for a chip skipped, the rest as the benchmark runs it. The program
comes out correct; with a fault planted in its train step, or with its
learner's products at bfloat16 (the control), it does not. On the card,
each cell runs as committed."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from port_bench import harness
from port_bench.faults import applicable

CELLS = ("ddpg.default", "dqn.suite")
SEED = 2 ** 31 + 101
BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))


def small(cell: str) -> dict:
    """The cell at 64 envs and (32, 32) nets, its cadence kept short; the
    learner at "kernel", whose plain twin runs on the CPU."""
    return {"num_envs": 64, "agent_config": {
        "hidden": [32, 32], "batch_size": 32, "updates_per_step": 2,
        "replay_capacity_per_env": 256, "learner": "kernel"}}


def _run(cell, **kw):
    return harness.run(cell, SEED, 0.5, False, torch.device("cpu"),
                       time.perf_counter(), overrides=small(cell), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_comes_out_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == set(
        harness.cell_metrics(BENCH, "end_to_end", cell))
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell, fault", [
    (c, f) for c in CELLS for f in applicable(harness.load_cell(c))])
def test_a_planted_fault_comes_out_incorrect(cell, fault):
    assert not _run(cell, fault=fault)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_incorrect(cell):
    assert not _run(cell, precision="bfloat16")["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_layers(cell):
    result = harness.run(cell, SEED, 0.5, True, torch.device("cpu"),
                         time.perf_counter(), overrides=small(cell))
    assert result["correct"]
    # Off the card only the host's cost has something to read.
    assert set(result["metrics"]) == {
        m for m in harness.cell_metrics(BENCH, "per_layer", cell)
        if m.split(".")[0] == "host_ms_per_step"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", cell, "--seed",
         str(SEED), "--seconds", "2", "--trace", "1"],
        cwd=harness.ROOT, env=dict(os.environ), capture_output=True,
        text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"], result["checks"]
