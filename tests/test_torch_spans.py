"""The port's host spans and wait counters (utils/spans.py) on the CPU:
under a profiler each agent's train step opens one `cp.train_step`
around its layers' spans, the presample's index copy counts one wait per
learning step (a CPU ring copies none, staged or blocking), the kernel
library counts its build and load, and with no profiler recording a span
is the shared null context and costs nothing else. Small sizes: 16 envs,
hidden (16, 16). No JAX."""

import contextlib
import io
import json
import os
import time
from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch import train
from cartpoleplusplus_tpu_torch.agents import (DDPG, DQN, LRPG, NAF,
                                               DDPGConfig, DQNConfig,
                                               LRPGConfig, NAFConfig, replay)
from cartpoleplusplus_tpu_torch.ops import _native
from cartpoleplusplus_tpu_torch.physics.params import continuous_params
from cartpoleplusplus_tpu_torch.utils import spans

B = 16
REPLAY = {"batch_size": 16, "updates_per_step": 2, "rollout_steps": 4,
          "replay_capacity_per_env": 32, "warmup_env_steps": 8}
# agent -> (class, config class, continuous env, its layers' spans)
AGENTS = {
    "ddpg": (DDPG, DDPGConfig, True, REPLAY),
    "dqn": (DQN, DQNConfig, False, REPLAY),
    "naf": (NAF, NAFConfig, True, REPLAY),
    "lrpg": (LRPG, LRPGConfig, False, {"rollout_steps": 4}),
}
LAYERS = {"cp.rollout", "cp.replay.insert", "cp.replay.presample",
          "cp.learner"}
PREP = {"ddpg": "cp.prep.B3", "dqn": "cp.prep.B5", "naf": "cp.prep.B7",
        "lrpg": "cp.prep.B9"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _agent(name, learner, **extra):
    cls, cfg_cls, continuous, cfg = AGENTS[name]
    params = continuous_params() if continuous else CartPoleParams()
    env = CartPole3D(params, num_envs=B, device="cpu")
    agent = cls(env, cfg_cls(hidden=(16, 16), learner=learner, **cfg,
                             **extra))
    return agent, agent.init(3)


def _cp_events(prof):
    """[(name, start ns, end ns)] of the profile's cp.* spans."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("cp.")]


@pytest.fixture
def opened(monkeypatch):
    """Every (name, args) a span is opened with."""
    calls = []

    class Spy(spans._Timed):
        def __init__(self, name, args=None):
            calls.append((name, args))
            super().__init__(name, args)

    monkeypatch.setattr(spans, "_Timed", Spy)
    return calls


@pytest.mark.parametrize("learner", ["kernel", "xla"])
@pytest.mark.parametrize("name", sorted(AGENTS))
def test_each_train_step_opens_one_span_around_its_layers(name, learner,
                                                          opened):
    agent, st = _agent(name, learner)
    st, _ = agent.train_step(st)      # a warm-up step, outside the profile
    steps = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            st, m = agent.train_step(st)
            steps.append(str(m["env_steps"]))
    events = _cp_events(prof)
    outer = [e for e in events if e[0] == "cp.train_step"]
    assert len(outer) == 2
    assert [a for n, a in opened if n == "cp.train_step"] == steps
    want = LAYERS if name != "lrpg" else {"cp.rollout", "cp.learner"}
    if learner == "kernel":
        want = want | {PREP[name]}
    for _, s, e in outer:
        inside = {n for n, s2, e2 in events
                  if n != "cp.train_step" and s <= s2 and e2 <= e}
        assert want <= inside, (name, learner, inside)
        assert inside <= want | {"cp.wait.indices"}
    # Every span of the window lies in a train step.
    assert all(any(s <= s2 and e2 <= e for _, s, e in outer)
               for _, s2, e2 in events)


@pytest.mark.parametrize("name", ["ddpg", "dqn", "naf"])
def test_the_index_copy_counts_one_wait_per_learning_step(name):
    agent, st = _agent(name, "xla")
    before = spans.wait.counts["indices"]
    learned = 0
    for _ in range(4):
        st, m = agent.train_step(st)
        learned += m["env_steps"] >= REPLAY["warmup_env_steps"]
    assert learned == 3
    assert spans.wait.counts["indices"] - before == learned


@pytest.mark.parametrize("sample", ["column", "block", "uniform"])
@pytest.mark.parametrize("name", ["ddpg", "dqn", "naf"])
def test_a_cpu_ring_counts_no_index_copy(name, sample):
    agent, st = _agent(name, "xla", sample=sample)
    before, waits = dict(replay.INDEX_COPIES), spans.wait.counts["indices"]
    for _ in range(4):
        st, _ = agent.train_step(st)
    assert spans.wait.counts["indices"] - waits == 3
    assert replay.INDEX_COPIES == before


def test_without_a_profiler_a_span_is_the_shared_null_context(opened):
    assert not torch.autograd._profiler_enabled()
    assert spans.span("cp.train_step", "8") is spans.NULL
    assert spans.wait("probe") is spans.NULL
    seconds, counts = dict(spans.span.seconds), dict(spans.span.counts)
    agent, st = _agent("ddpg", "kernel")
    for _ in range(3):
        st, _ = agent.train_step(st)
    assert opened == []
    assert dict(spans.span.seconds) == seconds
    assert dict(spans.span.counts) == counts


def test_the_spans_time_themselves_while_a_profiler_records():
    agent, st = _agent("dqn", "kernel")
    seconds = spans.span.seconds["cp.train_step"]
    counts = spans.span.counts.copy()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            st, _ = agent.train_step(st)
    events = _cp_events(prof)
    for name in {n for n, _, _ in events}:
        assert spans.span.counts[name] - counts[name] == sum(
            n == name for n, _, _ in events)
    took = spans.span.seconds["cp.train_step"] - seconds
    traced = sum(e - s for n, s, e in events if n == "cp.train_step") * 1e-9
    assert 0 < took <= traced


def test_the_library_counts_its_build_and_load(monkeypatch):
    def build():
        time.sleep(0.01)
        return 0.01

    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_stale", lambda: True)
    monkeypatch.setattr(_native, "build", build)
    monkeypatch.setattr(_native.ctypes, "CDLL", lambda path: mock.Mock())
    fn = _native.load_library
    for k in ("build_s", "load_s", "builds"):
        monkeypatch.setattr(fn, k, getattr(fn, k))
    builds, build_s, load_s = fn.builds, fn.build_s, fn.load_s
    lib = _native.load_library()
    assert _native.load_library() is lib
    assert fn.builds == builds + 1
    assert fn.build_s - build_s >= 0.01
    assert fn.load_s > load_s


def test_the_cli_trace_holds_the_spans_and_its_waits(tmp_path):
    argv = ["--device", "cpu", "--agent", "ddpg", "--num-envs", "16",
            "--ddpg.hidden", "16", "16", "--ddpg.rollout-steps", "2",
            "--ddpg.updates-per-step", "1", "--ddpg.batch-size", "16",
            "--ddpg.replay-capacity-per-env", "8",
            "--ddpg.warmup-env-steps", "0", "--total-env-steps", "6",
            "--log-interval", "1", "--no-final-eval",
            "--profile-dir", str(tmp_path / "prof"),
            "--event-log", str(tmp_path / "run.cpe")]
    before = spans.wait.counts.copy()
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert train.main(argv) == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    logged = sum("train_step" in x for x in lines)
    assert logged == 3
    assert spans.wait.counts["log"] - before["log"] == logged
    assert spans.wait.counts["eventlog"] - before["eventlog"] == 3
    with open(os.path.join(tmp_path, "prof", "trace.json")) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("cp.train_step") == 3
    assert names.count("cp.wait.log") == 3
    assert {"cp.rollout", "cp.learner", "cp.replay.presample",
            "cp.wait.indices", "cp.wait.eventlog"} <= set(names)
