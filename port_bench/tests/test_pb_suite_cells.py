"""The cells at the suite cadence that NAF's configuration brought,
`naf.suite` and `ddpg.suite`, on the CPU at a tiny size: NAF's plain
reference held to the program's own plain twins piece by piece (B6's twin
through the env, the column draw through NAF's ring, one update against
B7's twin), a whole run of each cell correct and each fault and the
control not, and the frozen counts of B6 and B7 giving PERF.md's bounds."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from port_bench import harness, weights
from port_bench.drivers import train_step
from port_bench.faults import applicable
from port_bench.reference.env import EnvParams
from port_bench.roofline import kernel
from port_bench.roofline.peaks import bound

CELLS = ("naf.suite", "ddpg.suite")
SEED = 2 ** 31 + 101
CPU = torch.device("cpu")
BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
# NAF at 48 envs and (24, 16) nets on the kernel learner, whose plain twin
# (B7's arithmetic) runs on the CPU and is the reference's subject; the
# plain learner (NafNet's tanh-mu Q) is not.
TINY = {"num_envs": 48, "agent_config": {
    "hidden": [24, 16], "batch_size": 40, "updates_per_step": 2,
    "replay_capacity_per_env": 256, "learner": "kernel", "rollout_steps": 8,
    "warmup_env_steps": 0}}
# A whole run: 64 envs, (32, 32) nets, the cadence kept short.
SMALL = {"num_envs": 64, "agent_config": {
    "hidden": [32, 32], "batch_size": 32, "updates_per_step": 2,
    "replay_capacity_per_env": 256, "learner": "kernel"}}


def _pair():
    """(cell, NAF's agent and state, the reference) from one seed and the
    same initial weights."""
    cell = harness.load_cell("naf.suite", TINY)
    agent = train_step.build_agent(cell, CPU)
    state = agent.init(SEED)
    init = train_step.initial_weights(cell, SEED, CPU)
    train_step.load_weights(cell, state, init)
    ref = train_step.reference_module(cell).Reference(
        cell.settings, EnvParams(**cell.config["env"]), cell.num_envs, init,
        SEED, CPU, weights.ADAM_V0)
    return cell, agent, state, ref


def _same(a, b, atol=0.0):
    assert a.shape == b.shape and a.dtype == b.dtype
    if atol:
        torch.testing.assert_close(a, b, rtol=0.0, atol=atol)
    else:
        assert torch.equal(a, b)


def test_naf_rollout_matches_b6s_twin():
    from cartpoleplusplus_tpu_torch.ops.naf_rollout import (
        reference_naf_rollout)

    cell, agent, st, ref = _pair()
    assert agent.kernel_mode
    c = agent.cfg
    for _ in range(2):
        env_state, obs, traj = reference_naf_rollout(
            agent.env, st.net, st.env_state, st.obs, st.env_steps,
            agent._sigma(st.env_steps), c.rollout_steps)
        st = st._replace(env_state=env_state, obs=obs,
                         env_steps=st.env_steps + c.rollout_steps)
        want = ref._rollout()
        ref.env_steps += c.rollout_steps
        for a, b in zip(traj, want):
            _same(a, b)
        _same(obs, ref.obs)


def test_naf_column_draw_matches_its_ring():
    """Three rollouts into NAF's ring and the reference's (the third wraps
    a ring of 20 slots mid-chunk), then one column draw of K 3 from the
    same generator's state."""
    cell = harness.load_cell("naf.suite", {**TINY, "agent_config": {
        **TINY["agent_config"], "replay_capacity_per_env": 20}})
    agent = train_step.build_agent(cell, CPU)
    st = agent.init(SEED)
    ref = train_step.reference_module(cell).Reference(
        cell.settings, EnvParams(**cell.config["env"]), cell.num_envs,
        train_step.initial_weights(cell, SEED, CPU), SEED, CPU)
    rs = st.replay
    for _ in range(3):
        traj = ref._rollout()
        rs = agent.replay.add_trajectory(rs, *traj)
        ref.ring.add(*traj)
    got = agent.replay.presample_columns(
        rs, 40, 3, generator=torch.Generator().manual_seed(9))
    want = ref.ring.columns(3, 40, torch.Generator().manual_seed(9))
    for a, b in zip(got, want):
        _same(a, b)


def test_naf_update_matches_b7s_twin():
    cell, agent, st, ref = _pair()
    ref.ring.add(*ref._rollout())
    ref.ring.add(*ref._rollout())
    batch = tuple(ref.ring.columns(
        1, cell.settings["batch_size"], torch.Generator().manual_seed(3)))
    st, metrics = agent._kernel_update_phase(st, batch)
    loss = ref._update(tuple(x[0] for x in batch))
    assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-6)
    params = dict(st.net.named_parameters())
    for k, p in ref.online["net"].items():
        _same(params[k].detach(), p.detach(), atol=1e-6)
    targets = dict(st.target.named_parameters())
    for k, p in ref.target.items():
        _same(targets[k].detach(), p, atol=1e-6)


def test_the_clip_fires_in_the_reference_as_in_b7s_twin():
    """At a max norm of 0.05, below every update's gradient norm, the
    reference's clipped update still gives the twin's weights."""
    cell, agent, st, ref = _pair()
    agent.cfg = dataclasses.replace(agent.cfg, max_grad_norm=0.05)
    ref.cfg = {**ref.cfg, "max_grad_norm": 0.05}
    ref.ring.add(*ref._rollout())
    batch = tuple(ref.ring.columns(
        1, cell.settings["batch_size"], torch.Generator().manual_seed(4)))
    st, _ = agent._kernel_update_phase(st, batch)
    ref._update(tuple(x[0] for x in batch))
    params = dict(st.net.named_parameters())
    for k, p in ref.online["net"].items():
        _same(params[k].detach(), p.detach(), atol=1e-6)


def _run(cell, **kw):
    return harness.run(cell, SEED, 0.5, False, CPU, time.perf_counter(),
                       overrides=SMALL, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_comes_out_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert result["notes"]["rollout_impl"] == 0.0   # no B6 off the card
    assert result["notes"]["learner_impl"] == 1.0
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
    result = harness.run(cell, SEED, 0.5, True, CPU, time.perf_counter(),
                         overrides=SMALL)
    assert result["correct"]
    # Off the card only the host's cost has something to read.
    assert set(result["metrics"]) == {
        m for m in harness.cell_metrics(BENCH, "per_layer", cell)
        if m.split(".")[0] == "host_ms_per_step"}


# PERF.md's kernel table: B6's and B7's bounds at the main path's shapes.
@pytest.mark.parametrize("k, agent_config, ms", [
    ("b6", {"rollout_steps": 8}, 0.0759),
    ("b7", {"batch_size": 256}, 0.0183),
])
def test_frozen_counts_reproduce_the_kernel_bounds(k, agent_config, ms):
    c = harness.load_cell("naf.suite", {"agent_config": agent_config})
    seconds, by = bound(*kernel(k).counts(c))
    assert by == "operations"
    assert round(seconds * 1e3, 4) == ms


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_card(cell):
    """As committed: B6 and B7 (B2 and B3) ran, not the plain path, and
    the traced run reads the cell's kernels' rooflines."""
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
    assert result["notes"]["rollout_impl"] == 1.0
    assert result["notes"]["learner_impl"] == 1.0
    kernels = harness.load_cell(cell).config["kernels"]
    assert {f"{k}_roofline" for k in kernels} <= set(result["metrics"])
