"""The port's train CLI run flags (cartpoleplusplus_tpu_torch/train.py) on
the CPU: the presets and their merges, checkpoint cadence and resume
under chunked dispatch, `--eval-only` (across lr configs, env counts and
learner layouts, and of a converted reference state), the canary, the
event log, `--eval-render` and `--profile-dir`, each against the
reference CLI where the reference pins it. Small sizes: 16-64 envs,
hidden (16, 16)."""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu import train as jtrain
from cartpoleplusplus_tpu.config import RunConfig as JRunConfig
from cartpoleplusplus_tpu_torch import train as ttrain
from cartpoleplusplus_tpu_torch.ckpt import CheckpointManager
from cartpoleplusplus_tpu_torch.ckpt.checkpoint import to_tree
from cartpoleplusplus_tpu_torch.config import (RunConfig, explicit_dests,
                                               from_args)
from cartpoleplusplus_tpu_torch.eventlog import read_records, validate
from test_torch_ckpt import _assert_tree_equal


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _run(main, argv):
    """main(argv) with stdout and stderr captured: (rc, JSON lines,
    stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, [json.loads(x) for x in out.getvalue().splitlines()], \
        err.getvalue()


def _steps_on_disk(d):
    return sorted(int(n) for n in os.listdir(d) if n.isdigit())


DQN_SMALL = ["--agent", "dqn", "--num-envs", "16", "--dqn.hidden", "16",
             "16", "--dqn.rollout-steps", "2", "--dqn.updates-per-step",
             "1", "--dqn.batch-size", "16", "--dqn.replay-capacity-per-env",
             "8", "--dqn.warmup-env-steps", "0"]
DDPG_SMALL = ["--agent", "ddpg", "--num-envs", "16", "--ddpg.hidden", "16",
              "16", "--ddpg.rollout-steps", "2",
              "--ddpg.updates-per-step", "1", "--ddpg.batch-size", "16",
              "--ddpg.replay-capacity-per-env", "8",
              "--ddpg.warmup-env-steps", "0"]
NAF_SMALL = ["--agent", "naf", "--num-envs", "16", "--naf.hidden", "16",
             "16", "--naf.rollout-steps", "2", "--naf.updates-per-step",
             "1", "--naf.batch-size", "16", "--naf.replay-capacity-per-env",
             "8", "--naf.warmup-env-steps", "0"]
CPU = ["--device", "cpu"]


# --- flags and presets ----------------------------------------------------

def test_presets_equal_reference():
    assert ttrain._PRESETS == jtrain._PRESETS


def test_run_fields_equal_reference_but_the_mesh():
    """RunConfig keeps every reference field, with its default, the mesh's
    two (`use_mesh`, `learner`) too since they were ported; the port adds
    only `device` and the process group's `dist_backend`."""
    ref = {f.name: f.default for f in dataclasses.fields(JRunConfig)}
    port = {f.name: f.default for f in dataclasses.fields(RunConfig)}
    assert not hasattr(ttrain, "_NOT_PORTED")
    assert set(ref) - set(port) == set()
    assert set(port) - set(ref) == {"device", "dist_backend"}
    assert all(port[k] == ref[k] for k in port if k in ref)


@pytest.mark.parametrize("flag", (["--use-mesh"], ["--no-use-mesh"],
                                  ["--learner", "shardmap"]))
def test_mesh_flags_rejected(flag):
    """The mesh's flags, rejected until they were ported, are accepted: a
    1-process run trains (the mesh is built only over several ranks), and
    `--learner shardmap` says on stderr, as the reference does, that it
    falls back to spmd there."""
    rc, lines, err = _run(ttrain.main, CPU + DDPG_SMALL + [
        "--total-env-steps", "4", "--log-interval", "1"] + flag)
    assert rc == 0 and len(lines) == 2
    assert ("falling back to spmd" in err) == (flag[0] == "--learner")
    assert "not ported" not in err


def _merged(main_mod, argv, preset, agent):
    """(run, agent config) of `argv` after the preset's merges, through
    each package's own parser, `explicit_dests` and `build`."""
    args = main_mod.build_parser().parse_args(argv)
    provided = (explicit_dests if main_mod is ttrain
                else jtrain.explicit_dests)(main_mod.build_parser(), argv)
    run = (from_args if main_mod is ttrain else jtrain.from_args)(
        RunConfig if main_mod is ttrain else JRunConfig, args)
    run = dataclasses.replace(run, **{
        k: v for k, v in main_mod._PRESETS[preset][agent]["run"].items()
        if k not in provided})
    _, ag = main_mod.build(run, args, provided)
    return run, ag.cfg


@pytest.mark.parametrize("case", [
    ("fast", "ddpg", ["--num-envs", "64", "--ddpg.updates-per-step", "2",
                      "--ddpg.replay-capacity-per-env", "8",
                      "--ddpg.hidden", "16", "16"]),
    ("fast", "naf", ["--num-envs", "16", "--naf.hidden", "16", "16",
                     "--canary-max-restarts", "1"]),
    ("fast", "lrpg", ["--num-envs", "16", "--steps-per-dispatch", "2",
                      "--lrpg.hidden", "16", "16"]),
    ("pixels", "ddpg", ["--num-envs", "8", "--ddpg.batch-size", "8",
                        "--render-size", "24", "--total-env-steps", "4",
                        "--ddpg.hidden", "16", "16"]),
])
def test_preset_merges_keep_typed_flags(case):
    """A preset lifts the unset run and agent fields to its recipe and
    never a field the user typed, as the reference's merge does."""
    preset, agent, extra = case
    argv = ["--agent", agent, "--preset", preset] + extra
    t_run, t_cfg = _merged(ttrain, argv + CPU, preset, agent)
    j_run, j_cfg = _merged(jtrain, argv, preset, agent)
    skip = {"device", "dist_backend"}  # the port's own
    assert {k: v for k, v in dataclasses.asdict(t_run).items()
            if k not in skip} == {k: v for k, v in
                                  dataclasses.asdict(j_run).items()
                                  if k not in skip}
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    typed = {a[2:].replace("-", "_") for a in extra if a.startswith("--")}
    for k, v in ttrain._PRESETS[preset][agent]["run"].items():
        assert getattr(t_run, k) == v or k in typed
    for k, v in ttrain._PRESETS[preset][agent]["agent"].items():
        assert getattr(t_cfg, k) == v or f"{agent}.{k}" in typed


def test_preset_errors_return_2():
    rc, _, err = _run(ttrain.main, CPU + ["--agent", "dqn", "--preset",
                                          "fast"])
    assert rc == 2
    assert "unknown preset 'fast' for agent 'dqn'; presets: ['fast:ddpg', " \
           "'fast:lrpg', 'fast:naf', 'pixels:ddpg']" in err
    # A ValueError while building (the preset pins the lrpg kernel
    # learner, which takes no zero-layer torso) carries the preset hint.
    rc, _, err = _run(ttrain.main, CPU + ["--agent", "lrpg", "--preset",
                                          "fast", "--lrpg.hidden"])
    assert rc == 2 and "invalid configuration: " in err
    assert "--preset fast may pin fields" in err


def test_preset_fast_lrpg_trains_with_its_kernel_learner():
    rc, lines, _ = _run(ttrain.main, CPU + [
        "--agent", "lrpg", "--preset", "fast", "--num-envs", "16",
        "--total-env-steps", "8", "--steps-per-dispatch", "2",
        "--log-interval", "1", "--lrpg.hidden", "16", "16",
        "--lrpg.rollout-steps", "2"])
    assert rc == 0
    assert [m["train_step"] for m in lines] == [2, 4]
    assert all(m["learner_impl"] == 1.0 for m in lines)


# --- checkpoints, chunked dispatch, the reference's cadence ---------------

def test_ckpt_cadence_under_chunked_dispatch(tmp_path):
    """Window-end steps (15, 31, ...) are no multiple of the interval: the
    forced save keeps them, and the final state is always on disk."""
    d = tmp_path / "ck"
    rc, _, _ = _run(ttrain.main, CPU + DQN_SMALL + [
        "--total-env-steps", "256", "--steps-per-dispatch", "16",
        "--log-interval", "1000", "--ckpt-dir", str(d), "--ckpt-interval",
        "5", "--no-ckpt-full"])
    assert rc == 0
    assert _steps_on_disk(d) == [95, 111, 127]
    d2 = tmp_path / "ck2"
    rc, _, _ = _run(ttrain.main, CPU + DQN_SMALL + [
        "--total-env-steps", "64", "--steps-per-dispatch", "16",
        "--log-interval", "1000", "--ckpt-dir", str(d2), "--ckpt-interval",
        "10000", "--no-ckpt-full"])
    assert rc == 0 and _steps_on_disk(d2) == [15, 31]
    keys = CheckpointManager(str(d2)).saved_keys()
    assert not {"replay", "env_state", "obs"} & set(keys)
    assert {"q", "q_target", "opt", "rng", "env_steps"} <= set(keys)


def test_steps_per_dispatch_is_bit_exact(tmp_path):
    """--steps-per-dispatch 4 ends on dispatch 1's state, bit for bit
    (compared through the final checkpoints), with the same last metrics
    line."""
    outs = []
    for spd in ("1", "4"):
        d = tmp_path / f"ck{spd}"
        rc, lines, _ = _run(ttrain.main, CPU + DDPG_SMALL + [
            "--total-env-steps", "24", "--steps-per-dispatch", spd,
            "--log-interval", "4", "--ckpt-dir", str(d)])
        assert rc == 0 and _steps_on_disk(d)[-1] == 11
        mgr = CheckpointManager(str(d))
        outs.append((torch.load(d / "11" / "state.pt", weights_only=True),
                     lines))
        assert mgr.latest_step() == 11
    _assert_tree_equal(outs[0][0], outs[1][0])
    last = [{k: v for k, v in m.items() if k != "env_steps_per_sec"}
            for m in (outs[0][1][-1], outs[1][1][-1])]
    assert last[0] == last[1]
    assert [m["train_step"] for m in outs[0][1]] == [4, 8, 12]


def test_logged_steps_and_saves_equal_reference(tmp_path):
    """The same small argv through the reference CLI and the port's: the
    same sequence of logged train_step values and the same saved steps
    (orbax's manager and the port's), with windows of 3 and a log
    interval that falls inside windows."""
    common = ["--agent", "lrpg", "--num-envs", "16", "--total-env-steps",
              "42", "--steps-per-dispatch", "3", "--log-interval", "4",
              "--ckpt-interval", "4", "--lrpg.hidden", "8",
              "--lrpg.rollout-steps", "2", "--lrpg.learner", "xla"]
    rc, t_lines, _ = _run(ttrain.main, CPU + common + [
        "--ckpt-dir", str(tmp_path / "t")])
    assert rc == 0
    rc, j_lines, _ = _run(jtrain.main, common + [
        "--ckpt-dir", str(tmp_path / "j"), "--no-use-mesh"])
    assert rc == 0
    assert [m["train_step"] for m in t_lines] == \
        [m["train_step"] for m in j_lines] == [6, 9, 12, 18, 21]
    assert _steps_on_disk(tmp_path / "t") == \
        _steps_on_disk(tmp_path / "j") == [14, 17, 20]


def test_resume_continues_and_appends_the_event_log(tmp_path):
    """A rerun resumes at latest + 1 (a finished run trains nothing more
    and keeps its log), a larger budget trains only the remaining calls,
    and the appended log continues each env's episode ids past the
    file's (the trailing open episode is abandoned), every logged
    env-step there once. Each run
    appends its metadata record, as the reference's does."""
    log = tmp_path / "run.cpe"
    argv = CPU + DQN_SMALL + [
        "--total-env-steps", "16", "--log-interval", "1", "--ckpt-dir",
        str(tmp_path / "ck"), "--ckpt-interval", "2", "--event-log",
        str(log), "--event-log-envs", "4", "--steps-per-dispatch", "2"]
    rc, lines, _ = _run(ttrain.main, argv)
    assert rc == 0 and lines[-1]["env_steps"] == 16.0
    n_records = validate(str(log))
    rc, lines, err = _run(ttrain.main, argv)
    assert rc == 0 and not lines and "resumed from step 7" in err
    assert validate(str(log)) == n_records + 1   # its metadata record
    argv[argv.index("--total-env-steps") + 1] = "32"
    rc, lines, err = _run(ttrain.main, argv)
    assert rc == 0 and "resumed from step 7" in err
    assert [m["train_step"] for m in lines] == [10, 12, 14, 16]
    assert lines[-1]["env_steps"] == 32.0
    runs, chunks = [], []
    for kind, rec in read_records(str(log)):
        if kind == "metadata":
            runs.append([])
        else:
            runs[-1].append(rec)
            chunks.append(rec)
    assert len(runs) == 3 and not runs[1]
    assert {c["env_id"] for c in chunks} == {0, 1, 2, 3}
    for env in range(4):
        first = [c["episode_id"] for c in runs[0] if c["env_id"] == env]
        later = [c["episode_id"] for c in runs[2] if c["env_id"] == env]
        assert min(later) == max(first) + 1
    assert sum(len(c["reward"]) for c in chunks) == 32 * 4


def test_resume_realigns_the_replay_cursor(tmp_path):
    """A checkpoint written under another rollout length: the cursor
    floors to the new chunk grid, with the reference's stderr line."""
    d = str(tmp_path / "ck")
    rc, _, _ = _run(ttrain.main, CPU + DQN_SMALL + [
        "--total-env-steps", "6", "--ckpt-dir", d])
    assert rc == 0
    argv = CPU + DQN_SMALL + ["--total-env-steps", "16", "--ckpt-dir", d]
    argv[argv.index("--dqn.rollout-steps") + 1] = "4"
    rc, _, err = _run(ttrain.main, argv)
    assert rc == 0
    assert "realigned replay cursor 6 -> 4 (rollout_steps=4)" in err


# --- --eval-only ------------------------------------------------------------

def test_eval_only_across_lr_config_and_env_count(tmp_path):
    """--eval-only restores the weights alone: a checkpoint written under
    an lr schedule and 16 envs evaluates at another lr config and 4
    envs; the eval of the restored weights differs from a fresh init's."""
    d = str(tmp_path / "ck")
    rc, _, _ = _run(ttrain.main, CPU + NAF_SMALL + [
        "--total-env-steps", "16", "--ckpt-dir", d,
        "--naf.lr-decay-env-steps", "8"])
    assert rc == 0
    argv = CPU + NAF_SMALL + ["--eval-only", "--eval-steps", "64"]
    argv[argv.index("--num-envs") + 1] = "4"
    rc, lines, err = _run(ttrain.main, argv + ["--ckpt-dir", d])
    assert rc == 0 and len(lines) == 1 and "resumed from step 7" in err
    assert lines[0]["episodes"] > 0
    rc, fresh, _ = _run(ttrain.main, argv)
    assert rc == 0 and fresh[0] != lines[0]


@pytest.mark.parametrize("agent", ("ddpg", "lrpg"))
def test_eval_only_equal_across_learner_layouts(tmp_path, agent):
    """A checkpoint of the kernel learner (its twin on the CPU) evaluates
    the same under --<agent>.learner xla and kernel: equal lines."""
    small = DDPG_SMALL if agent == "ddpg" else [
        "--agent", "lrpg", "--num-envs", "16", "--lrpg.hidden", "16", "16",
        "--lrpg.rollout-steps", "2"]
    base = CPU + small + ["--total-env-steps", "8", "--ckpt-dir",
                          str(tmp_path / "ck"), "--seed", "3"]
    rc, lines, _ = _run(ttrain.main, base + [f"--{agent}.learner", "kernel"])
    assert rc == 0 and lines[-1]["learner_impl"] == 1.0
    evals = []
    for learner in ("xla", "kernel"):
        rc, out, _ = _run(ttrain.main, base + [
            f"--{agent}.learner", learner, "--eval-only", "--eval-steps",
            "32", "--num-envs", "8"])
        assert rc == 0
        evals.append(out[0])
    assert evals[0] == evals[1]


def test_eval_only_of_a_converted_reference_state(tmp_path):
    """The reference trains DDPG for 8 calls and saves with orbax; the
    test restores that with orbax, converts it (models/from_jax.py), saves
    it through the port's manager, and the port's --eval-only prints the
    reference's --eval-only statistics: episode counts and the median and
    max lengths exact, the means within rtol 1e-5 (float32 sums in other
    orders; no termination flips at this size)."""
    from cartpoleplusplus_tpu.ckpt import CheckpointManager as JManager
    from cartpoleplusplus_tpu_torch.models.from_jax import (
        ddpg_state_from_jax)

    import jax

    common = ["--agent", "ddpg", "--num-envs", "16", "--ddpg.hidden", "16",
              "16", "--ddpg.rollout-steps", "2", "--ddpg.updates-per-step",
              "1", "--ddpg.batch-size", "16",
              "--ddpg.replay-capacity-per-env", "8",
              "--ddpg.warmup-env-steps", "0", "--ddpg.learner", "xla"]
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    rc, _, _ = _run(jtrain.main, common + [
        "--total-env-steps", "16", "--ckpt-dir", jd, "--no-use-mesh"])
    assert rc == 0 and _steps_on_disk(jd) == [0, 7]
    # The reference's own restore of its checkpoint, then the converter.
    jargs = jtrain.build_parser().parse_args(common)
    _, jagent = jtrain.build(jtrain.from_args(JRunConfig, jargs), jargs,
                             jtrain.explicit_dests(jtrain.build_parser(),
                                                   common))
    with JManager(jd) as jm:
        jstate = jax.device_get(jm.restore(jagent.init(0)))
    targs = ttrain.build_parser().parse_args(common + CPU)
    _, tagent = ttrain.build(from_args(RunConfig, targs), targs,
                             explicit_dests(ttrain.build_parser(),
                                            common + CPU))
    with CheckpointManager(td) as tm:
        assert tm.save(7, ddpg_state_from_jax(tagent, jstate))
    evals = ["--eval-only", "--eval-steps", "200", "--num-envs", "32"]
    rc, t_out, _ = _run(ttrain.main, CPU + common + evals + [
        "--ckpt-dir", td])
    assert rc == 0
    rc, j_out, _ = _run(jtrain.main, common + evals + [
        "--ckpt-dir", jd, "--no-use-mesh"])
    assert rc == 0
    t_ev, j_ev = t_out[0], j_out[0]
    assert t_ev.keys() == j_ev.keys()
    assert j_ev["episodes"] > 50
    for k in ("episodes", "median_episode_length", "max_episode_length"):
        assert t_ev[k] == j_ev[k], k
    for k in ("mean_episode_length", "reward_mean", "done_frac"):
        np.testing.assert_allclose(t_ev[k], j_ev[k], rtol=1e-5, err_msg=k)


def test_eval_render_writes_frames(tmp_path):
    d = tmp_path / "frames"
    rc, lines, err = _run(ttrain.main, CPU + DQN_SMALL + [
        "--eval-only", "--eval-steps", "5", "--eval-render", str(d)])
    assert rc == 0 and len(lines) == 1 and "wrote 5 frames" in err
    files = sorted(os.listdir(d))
    assert len(files) == 5 and files[0].startswith("step0000")


# --- the canary, the profiler ---------------------------------------------

def test_canary_restart_paths():
    """A healthy canary logs once and trains through; an always-failing
    one restarts re-seeded until canary_max_restarts, then finishes with
    the reference's lines."""
    base = CPU + DQN_SMALL + [
        "--total-env-steps", "32", "--eval-steps", "20",
        "--canary-env-steps", "8", "--log-interval", "1000"]
    base[base.index("--dqn.rollout-steps") + 1] = "4"
    rc, lines, _ = _run(ttrain.main, base + ["--canary-min-eval", "0.5"])
    assert rc == 0
    canary = [m for m in lines if "canary_eval_mean" in m]
    assert len(canary) == 1 and canary[0]["healthy"]
    assert canary[0]["attempt"] == 0 and canary[0]["canary_at_step"] == 2
    rc, lines, _ = _run(ttrain.main, base + ["--canary-min-eval", "1e9",
                                             "--canary-max-restarts", "2"])
    assert rc == 0
    canary = [m for m in lines if "canary_eval_mean" in m]
    assert [c["attempt"] for c in canary] == [0, 1, 2]
    assert not any(c["healthy"] for c in canary)
    assert lines[-1]["train_step"] == 8
    # The canary is clamped to the budget: one above it fires at the last
    # call.
    rc, lines, _ = _run(ttrain.main, base + [
        "--canary-env-steps", "1000", "--canary-min-eval", "0.5"])
    assert [m["canary_at_step"] for m in lines
            if "canary_eval_mean" in m] == [8]


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "prof"
    rc, _, _ = _run(ttrain.main, CPU + DQN_SMALL + [
        "--total-env-steps", "4", "--profile-dir", str(d)])
    assert rc == 0
    trace = json.loads((d / "trace.json").read_text())
    assert trace["traceEvents"]
