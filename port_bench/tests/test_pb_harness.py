"""The benchmark's files and counts: every cell resolves by name, every
name and unit keeps to the allowed characters, a run without a card fails,
and the frozen operation counts reproduce the kernels' bounds."""

from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys

import pytest

from port_bench import harness
from port_bench.roofline import kernel
from port_bench.roofline.peaks import bound

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = harness.load_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    config = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert os.path.isfile(os.path.join(harness.ROOT, config["file"]))
    assert config["file"].startswith("port_bench/configs/")
    ref = importlib.import_module(f"port_bench.reference.{cell.agent}")
    assert set(ref.shapes(cell.settings, cell.config["obs_dim"])) == set(
        cell.config["nets"])
    for k in cell.config["kernels"]:
        mod = kernel(k)
        assert mod.KERNEL and mod.counts(cell)[0] > 0 and mod.net_flop(cell)
    reads = harness.cell_metrics(BENCH, "per_layer", name)
    assert reads, "every cell reports a per-layer metric"
    for m in reads:
        assert callable(harness.reader(m).read)
    ends = harness.cell_metrics(BENCH, "end_to_end", name)
    assert "setup_s" in ends and len(ends) >= 2
    for m in BENCH["per_layer"]:
        if m["name"] in reads:
            assert m["moves"] in ends, (m["name"], name)
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert callable(cell.driver.setup)
    assert entry["chips"] == 1


def test_names_units_and_keys_keep_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["traffic"] for w in BENCH["workloads"]])
    assert all(NAME.fullmatch(n) for n in names), names
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    assert all(UNIT.fullmatch(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    moves = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in moves and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["layer"] and "\n" not in m["layer"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_run_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


# PERF.md's kernel table: each kernel's bound at the main path's shapes,
# from the counts these files froze.
@pytest.mark.parametrize("cell, k, agent_config, ms", [
    ("ddpg.default", "b3", {}, 0.0821),
    ("ddpg.default", "b3", {"batch_size": 8192, "updates_per_step": 8},
     1.3131),
    ("ddpg.default", "b2", {}, 0.0759),
    ("dqn.suite", "b5", {"batch_size": 256, "updates_per_step": 8}, 0.0231),
    ("dqn.suite", "b4", {"rollout_steps": 8}, 0.0767),
])
def test_frozen_counts_reproduce_the_kernel_bounds(cell, k, agent_config,
                                                   ms):
    c = harness.load_cell(cell, {"agent_config": agent_config})
    seconds, by = bound(*kernel(k).counts(c))
    assert by == "operations"
    assert round(seconds * 1e3, 4) == ms


def test_a_cell_without_a_ring_or_target_nets_is_files_alone(tmp_path,
                                                            monkeypatch):
    """A configuration whose agent keeps no replay ring and no target net
    (LRPG) needs only files: the harness loads its cell by name, builds
    the agent, loads the seed's weights into its one net, drives its
    compared steps and warm-up, and wraps its own spans, keeping the
    program's launch counters."""
    import types

    import torch
    from torch.profiler import profile

    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk
    from port_bench import faults, trace
    from port_bench.reference.nets import mlp_shapes

    dqn = json.load(open(os.path.join(harness.BENCH, "configs", "dqn.json")))
    files = tmp_path / "port_bench"
    for sub in ("configs", "traffic", "limits"):
        (files / sub).mkdir(parents=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({"workloads": [
        {"name": "lrpg.tiny", "config": "lrpg", "traffic": "tiny",
         "chips": 1}]}))
    (files / "configs" / "lrpg.json").write_text(json.dumps({
        "driver": "train_step", "agent": "lrpg", "obs_mode": "pose_stack",
        "obs_dim": 42, "env": dqn["env"],
        "agent_config": {"hidden": [16, 16], "rollout_steps": 4,
                         "learner": "kernel"},
        "nets": {"policy": {"module": "policy", "opt": "opt"}},
        "losses": ["loss"],
        "spans": {
            "rollout": ["cartpoleplusplus_tpu_torch.agents.lrpg",
                        "reference_pg_rollout"],
            "learner": ["cartpoleplusplus_tpu_torch.ops.learner_kernel",
                        "lrpg_update_phase"]},
        "kernels": []}))
    (files / "traffic" / "tiny.json").write_text(json.dumps(
        {"num_envs": 8, "agent_config": {}}))
    (files / "limits" / "lrpg.tiny.json").write_text(json.dumps(
        {"loss_gap": 1e-5}))
    # The reference's weights for the one net; no `schedule`: LRPG learns
    # from its first step and fills nothing.
    monkeypatch.setitem(sys.modules, "port_bench.reference.lrpg",
                        types.SimpleNamespace(shapes=lambda cfg, obs: {
                            "policy": mlp_shapes(obs, cfg["hidden"], 5,
                                                 "dense")}))

    cell = harness.load_cell("lrpg.tiny", root=str(tmp_path))
    drv, cpu = cell.driver, torch.device("cpu")
    assert drv.schedule(cell) == (1, 3, 3)
    assert faults.applicable(cell) == ["unchanged"]
    agent, step = drv.build(cell, cpu)
    state, prog, init, notes = drv.setup(cell, agent, step, 11, cpu)
    assert set(prog.losses) == {"loss"} and set(prog.moments) == {"policy"}
    assert notes["learner_impl"] == 1.0
    assert not torch.equal(prog.weights["policy"]["head.weight"],
                           init["policy"]["head.weight"])
    phase = lk.lrpg_update_phase
    launches = phase.launches
    with trace.spans(agent, cell.config["spans"]):
        with profile() as prof:
            state, _, _ = harness.window(step, state, 0.2, cpu)
        # The kernel counts its launches through the module's name, which
        # the span's wrapper holds in the window.
        lk.lrpg_update_phase.launches += 1
        assert lk.lrpg_update_phase is not phase
    assert {"rollout", "learner"} <= {e.name for e in prof.events()}
    assert lk.lrpg_update_phase is phase
    assert phase.launches == launches + 1
