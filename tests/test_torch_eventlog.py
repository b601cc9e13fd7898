"""The port's event log (cartpoleplusplus_tpu_torch/eventlog) against the
reference's on the CPU: the same records give the same bytes on both
backends, the sinks split the same trajectories into the same files, each
package reads and validates the other's files, and the reference's own
checks (corruption, bad magic, resume ids, pixel frames) hold for the
copy. Byte equality is exact: no tolerance."""

import contextlib
import io
import struct

import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu import eventlog as jlog
from cartpoleplusplus_tpu_torch import eventlog as tlog
from cartpoleplusplus_tpu_torch.eventlog import __main__ as tlog_cli
from cartpoleplusplus_tpu_torch.eventlog._native.build import (
    load as load_native)

BACKENDS = (True, False)  # use_native: the C++ engine, the Python path


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _write_sample(mod, path, use_native):
    """The reference test's sample: metadata and three chunks."""
    w = mod.EventLogWriter(str(path), metadata={"env": "cartpole3d", "n": 4},
                           use_native=use_native)
    rng = np.random.RandomState(0)
    for ep in range(3):
        t = 5 + ep
        w.write_chunk(ep, env_id=ep % 2,
                      state=rng.randn(t, 10).astype(np.float32),
                      action=rng.randn(t, 2).astype(np.float32),
                      reward=np.ones(t, np.float32),
                      done=np.arange(t) == t - 1)
    w.close()
    return w.backend


def _rollout(seed, t=17, b=6, d=5, act=2):
    rng = np.random.RandomState(seed)
    done = rng.rand(t, b) < 0.2
    done[-1, 0] = True   # a boundary exactly at the chunk end
    done[:, 1] = False   # an env with no boundary at all
    action = (rng.randint(0, 5, (t, b)).astype(np.int32) if act == 0
              else rng.randn(t, b, act).astype(np.float32))
    return (rng.randn(t, b, d).astype(np.float32), action,
            rng.rand(t, b).astype(np.float32), done)


def test_native_engine_builds():
    assert load_native() is not None, "the port's event-log engine failed " \
                                      "to build"
    with tlog.EventLogWriter("/dev/null", use_native=True) as w:
        assert w.backend == "native"


@pytest.mark.parametrize("use_native", BACKENDS)
def test_writer_bytes_equal_reference(tmp_path, use_native):
    """The port's writer, on either backend, writes the reference's
    Python writer's bytes."""
    p_t, p_j = tmp_path / "t.cpe", tmp_path / "j.cpe"
    backend = _write_sample(tlog, p_t, use_native)
    assert backend == ("native" if use_native else "python")
    _write_sample(jlog, p_j, False)
    assert p_t.read_bytes() == p_j.read_bytes()


@pytest.mark.parametrize("use_native", BACKENDS)
@pytest.mark.parametrize("act", (2, 0))
def test_sink_bytes_equal_reference(tmp_path, use_native, act):
    """The port's EpisodeSink, fed two rollouts (continuous and discrete
    actions), writes the reference's sink's file and ends on its episode
    counters."""
    rollout = _rollout(3, act=act)
    paths, ids = [], []
    for mod, native in ((tlog, use_native), (jlog, False)):
        p = tmp_path / f"{mod.__name__}.cpe"
        w = mod.EventLogWriter(str(p), metadata={"k": 1}, use_native=native)
        sink = mod.EpisodeSink(w, num_envs=6,
                               initial_episode_ids=np.arange(6))
        sink.add_rollout(*rollout)
        sink.add_rollout(*rollout)   # counters carry across calls
        w.close()
        paths.append(p)
        ids.append(sink.episode_ids.copy())
    np.testing.assert_array_equal(ids[0], ids[1])
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_sink_of_a_port_trajectory_equals_reference(tmp_path):
    """A real trajectory of the port (DQN's `train_step(capture=True)` at
    16 envs) through both packages' sinks: the same bytes."""
    from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
    from cartpoleplusplus_tpu_torch.agents import DQN, DQNConfig

    env = CartPole3D(CartPoleParams(), num_envs=16, device="cpu")
    agent = DQN(env, DQNConfig(hidden=(16,), rollout_steps=24,
                               updates_per_step=1, batch_size=16,
                               replay_capacity_per_env=32,
                               warmup_env_steps=0))
    st = agent.init(0)
    _, m = agent.train_step(st, capture=True)
    traj = [x.numpy() for x in m["traj"]]
    assert traj[0].shape == (24, 16, env.obs_size) and traj[3].any()
    out = []
    for mod in (tlog, jlog):
        p = tmp_path / f"{mod.__name__}.cpe"
        with mod.EventLogWriter(str(p), metadata={"obs": "pose_stack"}) as w:
            mod.EpisodeSink(w, num_envs=16).add_rollout(*traj)
        out.append(p.read_bytes())
    assert out[0] == out[1]
    logged = sum(r["reward"].sum() for k, r in
                 tlog.read_records(str(tmp_path / f"{tlog.__name__}.cpe"))
                 if k == "chunk")
    np.testing.assert_allclose(logged, traj[2].sum(), rtol=1e-6)


@pytest.mark.parametrize("writer", ("port", "reference"))
def test_files_cross_validate(tmp_path, writer):
    """A file written by one package passes the other's validate and
    reads back the same records."""
    wmod, rmod = (tlog, jlog) if writer == "port" else (jlog, tlog)
    p = tmp_path / "x.cpe"
    _write_sample(wmod, p, True)
    assert rmod.validate(str(p)) == 4
    got = list(rmod.read_records(str(p)))
    want = list(wmod.read_records(str(p)))
    assert [k for k, _ in got] == [k for k, _ in want]
    assert got[0][1] == want[0][1]
    for (_, a), (_, b) in zip(got[1:], want[1:]):
        for key in ("state", "action", "reward", "done"):
            np.testing.assert_array_equal(a[key], b[key])
        assert (a["episode_id"], a["env_id"]) == (b["episode_id"],
                                                  b["env_id"])


def test_roundtrip_python(tmp_path):
    p = tmp_path / "log.cpe"
    _write_sample(tlog, p, False)
    recs = list(tlog.read_records(str(p)))
    assert recs[0] == ("metadata", {"env": "cartpole3d", "n": 4})
    chunks = [r for k, r in recs if k == "chunk"]
    assert len(chunks) == 3 and chunks[2]["state"].shape == (7, 10)
    assert chunks[2]["done"][-1]
    assert tlog.validate(str(p)) == 4


@pytest.mark.parametrize("use_native", BACKENDS)
def test_corruption_detected(tmp_path, use_native):
    p = tmp_path / "log.cpe"
    _write_sample(tlog, p, use_native)
    blob = bytearray(p.read_bytes())
    blob[60] ^= 0xFF  # flip a payload byte
    p.write_bytes(bytes(blob))
    with pytest.raises(ValueError):
        tlog.validate(str(p))
    with pytest.raises(ValueError):
        list(tlog.read_records(str(p)))


def test_bad_magic_rejected(tmp_path):
    p = tmp_path / "bad.cpe"
    p.write_bytes(struct.pack("<II", 0xDEAD, 1))
    with pytest.raises(ValueError):
        list(tlog.read_records(str(p)))
    with pytest.raises(ValueError):
        tlog.validate(str(p))


def test_episode_sink_splits_on_done(tmp_path):
    p = tmp_path / "sink.cpe"
    w = tlog.EventLogWriter(str(p), use_native=False)
    sink = tlog.EpisodeSink(w, num_envs=2)
    t, b = 6, 2
    state = np.zeros((t, b, 3), np.float32)
    action = np.zeros((t, b, 2), np.float32)
    reward = np.ones((t, b), np.float32)
    done = np.zeros((t, b), bool)
    done[2, 0] = True   # env 0 finishes an episode at step 2
    sink.add_rollout(state, action, reward, done)
    sink.add_rollout(state, action, reward, np.zeros((t, b), bool))
    w.close()
    chunks = [r for k, r in tlog.read_records(str(p)) if k == "chunk"]
    env0 = [c for c in chunks if c["env_id"] == 0]
    env1 = [c for c in chunks if c["env_id"] == 1]
    assert [c["episode_id"] for c in env0] == [0, 1, 1]
    assert [len(c["reward"]) for c in env0] == [3, 3, 6]
    assert [c["episode_id"] for c in env1] == [0, 0]


@pytest.mark.parametrize("use_native", BACKENDS)
def test_sink_pixel_obs_stored_as_frames(tmp_path, use_native):
    """obs_as_frames: image observations land in the uint8 frames field,
    within 1/255 of the float frames, as the reference's sink stores
    them (same bytes)."""
    rng = np.random.RandomState(0)
    obs = rng.rand(3, 2, 4, 4, 3).astype(np.float32)  # (T, B, H, W, C)
    out = []
    for mod, native in ((tlog, use_native), (jlog, False)):
        p = tmp_path / f"{mod.__name__}.cpe"
        w = mod.EventLogWriter(str(p), use_native=native)
        mod.EpisodeSink(w, num_envs=2, obs_as_frames=True).add_rollout(
            obs, np.zeros((3, 2, 2), np.float32),
            np.ones((3, 2), np.float32), np.zeros((3, 2), bool))
        w.close()
        out.append(p)
    assert out[0].read_bytes() == out[1].read_bytes()
    chunks = [r for k, r in tlog.read_records(str(out[0])) if k == "chunk"]
    assert chunks[0]["state"].shape[1] == 0
    got = chunks[0]["frames"].reshape(3, 4, 4, 3).astype(np.float32) / 255.0
    np.testing.assert_allclose(got, obs[:, 0], atol=1 / 255.0 + 1e-6)


@pytest.mark.parametrize("use_native", BACKENDS)
def test_next_episode_ids_seeds_resume(tmp_path, use_native):
    """Appending continues per-env episode numbering past the ids in the
    file, as the reference's next_episode_ids gives them."""
    p = tmp_path / "resume.cpe"
    w = tlog.EventLogWriter(str(p), use_native=use_native)
    sink = tlog.EpisodeSink(w, num_envs=2)
    t, b = 6, 2
    state = np.zeros((t, b, 3), np.float32)
    action = np.zeros((t, b, 2), np.float32)
    reward = np.ones((t, b), np.float32)
    done = np.zeros((t, b), bool)
    done[1, 0] = done[4, 0] = True
    done[2, 1] = True
    sink.add_rollout(state, action, reward, done)
    w.close()
    ids = tlog.next_episode_ids(str(p), 4)
    np.testing.assert_array_equal(ids, [3, 2, 0, 0])
    np.testing.assert_array_equal(ids, jlog.next_episode_ids(str(p), 4))

    w2 = tlog.EventLogWriter(str(p), append=True, use_native=use_native)
    sink2 = tlog.EpisodeSink(w2, num_envs=2, initial_episode_ids=ids[:2])
    sink2.add_rollout(state, action, reward, np.zeros((t, b), bool))
    w2.close()
    pairs = [(c["env_id"], c["episode_id"])
             for k, c in tlog.read_records(str(p)) if k == "chunk"]
    assert len(pairs) == len(set(pairs))
    assert jlog.validate(str(p)) == tlog.validate(str(p))


def test_cli_dump_and_validate(tmp_path):
    """`python -m cartpoleplusplus_tpu_torch.eventlog dump|validate`, and
    `dump --frames --png` of a pixel log through the port's viz."""
    p = tmp_path / "px.cpe"
    rng = np.random.RandomState(1)
    obs = rng.rand(4, 1, 6, 6, 3).astype(np.float32)
    with tlog.EventLogWriter(str(p), metadata={"obs_shape": [6, 6, 3]}) as w:
        tlog.EpisodeSink(w, num_envs=1, obs_as_frames=True).add_rollout(
            obs, np.zeros((4, 1, 2), np.float32),
            np.ones((4, 1), np.float32), np.arange(4)[:, None] == 3)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tlog_cli.main(["validate", str(p)]) == 0
        assert tlog_cli.main(["dump", str(p), "--frames",
                              str(tmp_path / "fr"), "--png"]) == 0
    text = out.getvalue()
    assert "2 records OK" in text and "1 chunks" in text
    assert len(list((tmp_path / "fr").iterdir())) == 4
