"""The port's train CLI over several ranks on the CPU, launched as users
launch it: `python -m torch.distributed.run --standalone --nproc-per-node
N -m cartpoleplusplus_tpu_torch.train ...` (torchrun picks a free port for
its own rendezvous), gloo, one thread per rank, each rank's output in its
own log file. The ranks import no JAX; each launch ends by its own
timeout.
"""

import contextlib
import glob
import io
import json
import os
import re
import signal
import subprocess
import sys

import pytest
import torch

from cartpoleplusplus_tpu_torch import train as ttrain
from cartpoleplusplus_tpu_torch.dist.mesh import resolve_backend
from test_torch_ckpt import _assert_tree_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
SMALL = ["--device", "cpu", "--num-envs", "32", "--ddpg.hidden", "16", "16",
         "--ddpg.rollout-steps", "2", "--ddpg.updates-per-step", "1",
         "--ddpg.batch-size", "16", "--ddpg.replay-capacity-per-env", "8",
         "--ddpg.warmup-env-steps", "0", "--log-interval", "1",
         "--steps-per-dispatch", "2", "--ckpt-interval", "2",
         "--final-eval", "--eval-steps", "50"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rank_codes(world, rc, err):
    """Each rank's exit code: torchrun exits 1 when a rank fails and lists
    every failed rank's code on its stderr."""
    codes = [0] * world
    for rank, code in re.findall(r"rank\s*:\s*(\d+).*\n\s*exitcode\s*:"
                                 r"\s*(-?\d+)", err):
        codes[int(rank)] = int(code)
    assert (rc == 0) == (codes == [0] * world), err
    return codes


def launch(world, argv, tmp, tag, cwd=REPO):
    """`world` ranks of the CLI run in `cwd` under torchrun: (each rank's
    exit code, rank 0's JSON lines, rank 0's stderr, the other ranks'
    stdout). A launch still running after TIMEOUT_S is killed with every
    rank."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    logs = os.path.join(str(tmp), f"logs-{tag}")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(world), "--log-dir", logs, "--redirects",
         "3", "-m", "cartpoleplusplus_tpu_torch.train", *argv],
        cwd=str(cwd), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        _, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()

    def read(rank, name):
        path, = glob.glob(os.path.join(logs, "*", "attempt_0", str(rank),
                                       f"{name}.log"))
        with open(path) as f:
            return f.read()

    lines = [json.loads(x) for x in read(0, "stdout").splitlines()]
    return (_rank_codes(world, proc.returncode, err), lines,
            read(0, "stderr"), [read(r, "stdout") for r in range(1, world)])


def _main(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = ttrain.main(argv)
    return rc, [json.loads(x) for x in out.getvalue().splitlines()], \
        err.getvalue()


def _untimed(lines):
    return [{k: v for k, v in m.items() if k != "env_steps_per_sec"}
            for m in lines]


def test_spmd_run_equals_one_process(tmp_path):
    """A 2-rank `--learner spmd` run (checkpoints, event log of 24 envs
    across both ranks, dispatch windows of 2, final eval) prints the
    1-process run's metric lines but their timing field, rank 1 prints
    nothing, both write the same checkpoints, and the event logs are byte
    for byte equal. The 2-rank checkpoint restores into a 1-process
    `--eval-only` (the 1-process checkpoint's eval line) and into a
    2-rank resume (the 1-process resume's lines)."""
    # The same relative paths in two directories: the log's metadata
    # holds the run's flags.
    w2, w1 = tmp_path / "two", tmp_path / "one"
    run = SMALL + ["--event-log-envs", "24", "--total-env-steps", "8",
                   "--ckpt-dir", "ck", "--event-log", "run.cpe",
                   "--canary-env-steps", "8", "--canary-min-eval", "1000",
                   "--canary-max-restarts", "1"]
    for w in (w2, w1):
        w.mkdir()
    rcs, lines2, err2, others = launch(2, run, tmp_path, "a", cwd=w2)
    assert rcs == [0, 0], err2
    assert others == [""]
    rcs, lines1, err1, _ = launch(1, run, tmp_path, "c", cwd=w1)
    # Two canary lines (the run restarts once), 2 windows x 2 attempts
    # of which the first attempt's last line is dropped by the restart,
    # and the final eval.
    assert rcs == [0] and len(lines1) == 6, err1
    assert [m.get("attempt") for m in lines1 if "canary_at_step" in m] \
        == [0, 1]
    assert _untimed(lines2) == _untimed(lines1)
    assert (w2 / "run.cpe").read_bytes() == (w1 / "run.cpe").read_bytes()
    d2, d1 = w2 / "ck", w1 / "ck"
    for step in ("1", "3"):
        _assert_tree_equal(
            torch.load(d2 / step / "state.pt", weights_only=True),
            torch.load(d1 / step / "state.pt", weights_only=True))
    evals = [_main(SMALL + ["--ckpt-dir", str(d), "--eval-only"])
             for d in (d2, d1)]
    assert evals[0][0] == 0 and evals[0][1] == evals[1][1]
    longer = SMALL + ["--total-env-steps", "12"]
    rcs, resumed2, err, _ = launch(2, longer + ["--ckpt-dir", str(d2)],
                                   tmp_path, "b")
    assert rcs == [0, 0] and "resumed from step 3" in err
    rc, resumed1, _ = _main(longer + ["--ckpt-dir", str(d1)])
    assert rc == 0 and _untimed(resumed2) == _untimed(resumed1)


def test_shardmap_runs_and_resumes(tmp_path):
    """`--learner shardmap` on 2 ranks trains (the kernel learner's twin:
    the minibatches all-gathered), checkpoints, and a rerun with a larger
    budget resumes from the last step; its final eval restores into a
    1-process `--eval-only` with the same statistics."""
    ck = tmp_path / "ck"
    argv = SMALL + ["--learner", "shardmap", "--ddpg.learner", "kernel",
                    "--ckpt-dir", str(ck)]
    rcs, lines, err, _ = launch(2, argv + ["--total-env-steps", "4"],
                                tmp_path, "a")
    assert rcs == [0, 0], err
    assert [m.get("train_step") for m in lines[:-1]] == [2]
    assert lines[-1]["eval_episodes"] > 0
    assert all(m["learner_impl"] == 1.0 for m in lines[:-1])
    rcs, lines, err, _ = launch(2, argv + ["--total-env-steps", "8"],
                                tmp_path, "b")
    assert rcs == [0, 0] and "resumed from step 1" in err
    assert [m.get("train_step") for m in lines[:-1]] == [4]
    rc, ev, _ = _main(SMALL + ["--ckpt-dir", str(ck), "--eval-only",
                               "--eval-steps", "50", "--seed", "1"])
    assert rc == 0
    frames = tmp_path / "frames"
    rcs, ev2, err, _ = launch(2, SMALL + [
        "--ckpt-dir", str(ck), "--eval-only", "--eval-steps", "4",
        "--eval-render", str(frames)], tmp_path, "c")
    assert rcs == [0, 0] and "wrote 4 frames" in err and len(ev2) == 1
    assert len(os.listdir(frames)) == 4
    want = {k[len("eval_"):]: v for k, v in lines[-1].items()}
    assert set(ev[0]) == set(want)
    for k, v in want.items():
        assert ev[0][k] == pytest.approx(v, rel=1e-6), k


def test_fallbacks_and_exit_codes(tmp_path, monkeypatch):
    """The reference's lines and exit codes: shardmap with num_envs that
    does not divide over the ranks exits 2; the random agent runs the
    spmd path whatever --learner says (the reference's random flow returns
    before its learner check), its one stats line the 1-process run's; an
    unknown learner exits 2; a backend the device cannot take exits 2
    before any rank joins. Under torchrun a failed rank makes the launch
    exit 1 and stop the other ranks."""
    rcs, lines, err, _ = launch(2, SMALL + ["--num-envs", "33", "--learner",
                                            "shardmap"], tmp_path, "a")
    # Every rank exits 2; torchrun stops the ranks still shutting down
    # once the first has failed (SIGTERM: -15).
    assert 2 in rcs and set(rcs) <= {2, -signal.SIGTERM} and not lines
    assert "--learner shardmap needs num_envs divisible by the " \
        "2-device mesh" in err
    # Under spmd every rank runs all 33 envs (the reference's partitioner
    # replicates what does not divide): the 1-process lines.
    odd = SMALL + ["--num-envs", "33", "--total-env-steps", "4"]
    rcs, lines, err, _ = launch(2, odd, tmp_path, "c")
    assert rcs == [0, 0] and "every rank runs all envs" in err
    assert _untimed(lines) == _untimed(_main(odd)[1])
    rand = ["--device", "cpu", "--agent", "random", "--num-envs", "32",
            "--total-env-steps", "20"]
    rcs, lines, err, others = launch(2, rand + ["--learner", "shardmap"],
                                     tmp_path, "b")
    assert rcs == [0, 0] and others == [""]
    assert lines == _main(rand)[1]
    rc, lines, err = _main(SMALL + ["--learner", "pmap"])
    assert rc == 2 and "unknown learner 'pmap'" in err
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    rc, _, err = _main(SMALL + ["--dist-backend", "nccl"])
    assert rc == 2 and "invalid distribution" in err


def test_backend_follows_the_device():
    """gloo on the CPU; NCCL on CUDA with a card per local rank; ranks
    sharing a card need an explicit gloo (NCCL takes one rank per card)."""
    assert resolve_backend("cpu", None, 2, 0) == "gloo"
    assert resolve_backend("cuda", "auto", 2, 2) == "nccl"
    assert resolve_backend("cuda", "gloo", 2, 1) == "gloo"
    for backend in (None, "auto", "nccl"):
        with pytest.raises(ValueError, match="share 1 CUDA card"):
            resolve_backend("cuda", backend, 2, 1)
    with pytest.raises(ValueError, match="needs CUDA"):
        resolve_backend("cpu", "nccl", 2, 0)
