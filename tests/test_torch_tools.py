"""The port's tools against the JAX package on the CPU: the URDF assets
and loader, the autodiff Lagrangian, the gym adapter, the numerical
guards, the sweep runner and the plots, and the env throughput harness."""

import argparse
import dataclasses
import filecmp
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu.bench import harness as jharness
from cartpoleplusplus_tpu.env import gym_adapter as jgym
from cartpoleplusplus_tpu.physics import lagrangian as jlag
from cartpoleplusplus_tpu.physics import params as jparams
from cartpoleplusplus_tpu.physics import urdf as jurdf
from cartpoleplusplus_tpu.utils import checks as jchecks
from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch import plot as tplot
from cartpoleplusplus_tpu_torch import sweep as tsweep
from cartpoleplusplus_tpu_torch.bench import harness
from cartpoleplusplus_tpu_torch.env import gym_adapter as tgym
from cartpoleplusplus_tpu_torch.models.from_jax import env_state_from_jax
from cartpoleplusplus_tpu_torch.physics import lagrangian, solve_accel, urdf
from cartpoleplusplus_tpu_torch.physics.params import continuous_params
from cartpoleplusplus_tpu_torch.utils import checks

# The env's parity bar against the reference (tests/test_torch_env.py).
ENV_RTOL, ENV_ATOL = 2e-5, 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# --- URDF ---------------------------------------------------------------------

def test_urdf_assets_are_the_references():
    """The port ships its own copy of the three bodies, byte for byte."""
    for name in ("cart.urdf", "pole.urdf", "ground.urdf"):
        assert filecmp.cmp(os.path.join(urdf.DEFAULT_ASSET_DIR, name),
                           os.path.join(jurdf.DEFAULT_ASSET_DIR, name),
                           shallow=False), name
    assert urdf.DEFAULT_ASSET_DIR != jurdf.DEFAULT_ASSET_DIR


@pytest.mark.parametrize("edit", [None, ('mass value="0.1"',
                                          'mass value="0.3"'),
                                  ('length="1.0"', 'length="1.6"')],
                         ids=["bundled", "pole_mass", "pole_length"])
def test_params_from_urdf_match_reference(tmp_path, edit):
    """Every CartPoleParams field from the bundled files, and from a copy
    with one edit of pole.urdf, equals the reference loader's, and the
    edit moves the field it names (and the bodies' dicts agree)."""
    asset = str(tmp_path)
    for name in ("cart.urdf", "pole.urdf", "ground.urdf"):
        shutil.copy(os.path.join(urdf.DEFAULT_ASSET_DIR, name), asset)
    if edit:
        path = os.path.join(asset, "pole.urdf")
        text = open(path).read()
        assert edit[0] in text
        open(path, "w").write(text.replace(*edit))
    got = dataclasses.asdict(urdf.params_from_urdf(asset))
    want = dataclasses.asdict(jurdf.params_from_urdf(asset))
    assert got == want
    for name in ("cart.urdf", "pole.urdf", "ground.urdf"):
        assert urdf.load_body(os.path.join(asset, name)) == \
            jurdf.load_body(os.path.join(asset, name))
    defaults = dataclasses.asdict(CartPoleParams())
    moved = {k for k in got if got[k] != defaults[k]}
    assert moved == ({"pole_mass"} if edit and "mass" in edit[0] else
                     {"pole_length"} if edit else set())
    over = urdf.params_from_urdf(asset, pole_mass=0.25)
    assert dataclasses.asdict(over) == dict(want, pole_mass=0.25)


# --- the autodiff Lagrangian --------------------------------------------------

def _random_state(seed, max_tilt=0.8):
    """tests/test_dynamics.py's seeded state and generalized force."""
    key = jax.random.PRNGKey(seed)
    kq, kf = jax.random.split(key)
    k1, k2, k3, k4 = jax.random.split(kq, 4)
    s = jax.random.uniform(k1, (2,), minval=-0.6, maxval=0.6)
    s = s * jnp.minimum(1.0, max_tilt / jnp.linalg.norm(s))
    sd = jax.random.uniform(k2, (2,), minval=-2.0, maxval=2.0)
    q = jnp.concatenate([jax.random.uniform(k3, (3,), minval=-1.0,
                                            maxval=1.0), s])
    qd = jnp.concatenate([jax.random.uniform(k4, (3,), minval=-2.0,
                                             maxval=2.0), sd])
    f = jax.random.uniform(kf, (5,), minval=-5.0, maxval=5.0)
    return q, qd, f


_reference_autodiff = jax.jit(jlag.solve_accel_autodiff, static_argnums=0)


@pytest.mark.parametrize("seed", range(8))
def test_autodiff_lagrangian_matches_reference_and_closed_form(seed):
    """On tests/test_dynamics.py's 8 seeded states: the port's autodiff
    solver agrees with the reference's and with the port's closed-form
    solve_accel at rtol 2e-4 / atol 2e-4 (test_dynamics.py's bar)."""
    q, qd, f = _random_state(seed)
    want = np.asarray(_reference_autodiff(jparams.CartPoleParams(), q, qd,
                                          f))
    tq, tqd, tf = (torch.tensor(np.asarray(x)) for x in (q, qd, f))
    p = CartPoleParams()
    got = lagrangian.solve_accel_autodiff(p, tq, tqd, tf).numpy()
    closed = torch.stack(solve_accel(p, tq[3], tq[4], tqd[3], tqd[4],
                                     *tf)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(closed, got, rtol=2e-4, atol=2e-4)
    lag = float(lagrangian.lagrangian(p, tq, tqd))
    np.testing.assert_allclose(
        lag, float(jlag.lagrangian(jparams.CartPoleParams(), q, qd)),
        rtol=1e-6, atol=1e-6)


# --- the gym adapter ----------------------------------------------------------

def _policy_actions(space, n, seed):
    rng = np.random.RandomState(seed)
    return [space.sample(rng) for _ in range(n)]


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["discrete", "continuous"])
def test_gym_episode_matches_reference(continuous):
    """GymCartPole3D on the CPU against the reference's from the same seed
    and actions, two episodes (the second from the derived seed of
    episode 1): observations within the env's parity bar, dones, info and
    the step count exact, rewards exact on the discrete env and within
    the env's parity bar on the continuous env's shaped reward; render()
    within 1 in 255."""
    p = continuous_params() if continuous else CartPoleParams()
    jp = jparams.continuous_params() if continuous \
        else jparams.CartPoleParams()
    env = tgym.GymCartPole3D(p, seed=3, device="cpu")
    ref = jgym.GymCartPole3D(jp, seed=3)
    for episode in range(2):
        np.testing.assert_allclose(env.reset(), ref.reset(), rtol=ENV_RTOL,
                                   atol=ENV_ATOL)
        actions = _policy_actions(ref.action_space, 300, seed=episode)
        steps = 0
        for a in actions:
            got, want = env.step(a), ref.step(a)
            steps += 1
            np.testing.assert_allclose(got[0], want[0], rtol=ENV_RTOL,
                                       atol=ENV_ATOL)
            if continuous:  # the shaped reward: float arithmetic
                np.testing.assert_allclose(got[1], want[1], rtol=ENV_RTOL,
                                           atol=ENV_ATOL)
            else:
                assert got[1] == want[1]
            assert got[2] == want[2]
            assert set(got[3]) == set(want[3])
            for k in want[3]:
                assert got[3][k] == want[3][k], k
            if want[2]:
                break
        assert want[2] and 1 <= steps <= 200
        img, jimg = env.render(), ref.render()
        assert img.dtype == np.uint8 and img.shape == jimg.shape
        assert img.shape[-1] == 3
        assert np.abs(img.astype(int) - jimg.astype(int)).max() <= 1


def test_gym_spaces_and_opts_match_reference():
    """The action and observation spaces of every obs mode and both
    action sets, and the flags add_opts contributes, equal the
    reference's; from_opts builds the env the flags describe."""
    for obs_mode in ("pose_stack", "state", "pixels"):
        for disc in (True, False):
            env = tgym.GymCartPole3D(CartPoleParams(discrete_actions=disc),
                                     obs_mode=obs_mode, device="cpu")
            ref = jgym.GymCartPole3D(jparams.CartPoleParams(
                discrete_actions=disc), obs_mode=obs_mode)
            for a, b in ((env.action_space, ref.action_space),
                         (env.observation_space, ref.observation_space)):
                assert type(a).__name__ == type(b).__name__
                assert a.shape == b.shape and a.dtype == b.dtype
                if hasattr(b, "n"):
                    assert a.n == b.n
                else:
                    np.testing.assert_array_equal(a.low, b.low)
                    np.testing.assert_array_equal(a.high, b.high)
    parsers = []
    for cls in (tgym.GymCartPole3D, jgym.GymCartPole3D):
        ap = argparse.ArgumentParser()
        cls.add_opts(ap)
        parsers.append(sorted(s for a in ap._actions
                              for s in a.option_strings))
    assert parsers[0] == parsers[1]
    ap = argparse.ArgumentParser()
    tgym.GymCartPole3D.add_opts(ap)
    args = ap.parse_args(["--env.pole-length", "2.0",
                          "--no-env.discrete-actions"])
    env = tgym.GymCartPole3D.from_opts(args, device="cpu")
    assert isinstance(env.action_space, tgym.Box)
    assert env._env.params.pole_length == 2.0
    env.reset()
    obs, reward, done, info = env.step(np.array([0.5, -0.5]))
    assert np.isfinite(reward) and obs.shape == env.observation_space.shape


def test_gym_seed_restarts_the_episode_sequence():
    env = tgym.GymCartPole3D(seed=5, device="cpu")
    first = [env.reset() for _ in range(2)][-1]
    a = env.step(0)[0]
    env.seed(5)
    env.reset()
    np.testing.assert_array_equal(env.reset(), first)
    np.testing.assert_array_equal(env.step(0)[0], a)
    with pytest.raises(RuntimeError, match="reset"):
        tgym.GymCartPole3D(device="cpu").step(0)


def test_gym_adapter_defaults_to_the_card():
    """The adapter, like the env under it, runs on the card unless asked:
    its env's device is cuda (nothing is allocated before reset)."""
    assert tgym.GymCartPole3D()._env.device.type == "cuda"


# --- the numerical guards -----------------------------------------------------

def _corrupt(state, case):
    """One corruption of an EnvState (either package's) per case."""
    ph = state.phys
    if case == "pos":
        return state._replace(phys=ph._replace(pos=_set(ph.pos, np.nan)))
    if case == "sd":
        return state._replace(phys=ph._replace(sd=_set(ph.sd, np.inf)))
    if case == "steps":
        return state._replace(steps=state.steps - 500)
    assert case == "none"
    return state


def _set(x, value):
    if isinstance(x, torch.Tensor):
        x = x.clone()
        x[0, 0] = value
        return x
    return x.at[0, 0].set(value)


@pytest.mark.parametrize("case", ["none", "pos", "sd", "steps"])
def test_checked_step_matches_reference(case):
    """checked_step over 4 envs from the same state and the same
    corruption: the port's err carries the reference's message (the
    first failed check in the reference's order), or none on a clean
    state; err.throw() raises it."""
    jenv = JCartPole3D(jparams.CartPoleParams(), num_envs=4)
    env = CartPole3D(CartPoleParams(), num_envs=4, device="cpu")
    jst, _ = jax.jit(jenv.reset)(0)
    st = env_state_from_jax(jax.device_get(jst))
    jerr, _ = jchecks.checked_step(jenv)(_corrupt(jst, case),
                                         jnp.zeros((4,), jnp.int32))
    err, out = checks.checked_step(env)(_corrupt(st, case),
                                        torch.zeros(4, dtype=torch.int32))
    want = jerr.get()
    if case == "none":
        assert want is None and err.get() is None
        err.throw()
        assert torch.isfinite(out[1]).all()
        return
    assert err.get() is not None and err.get() in want, (err.get(), want)
    with pytest.raises(ValueError, match=err.get().replace("|", r"\|")):
        err.throw()
    with pytest.raises(checks.CheckError):
        checks.check_state(env, out[0])


def test_check_state_names_each_check():
    env = CartPole3D(CartPoleParams(), num_envs=4, device="cpu")
    st, _ = env.reset(0)
    checks.check_state(env, st)
    ph = st.phys
    for bad, msg in (
            (st._replace(phys=ph._replace(s=ph.s * 0 + 0.9)),
             "pole direction left the |s| chart"),
            (st._replace(phys=ph._replace(vel=ph.vel + 200.0)),
             "velocity exceeded vel_max clamp"),
            (st._replace(steps=st.steps - 1), "negative step counter"),
            (st._replace(phys=ph._replace(vel=ph.vel * np.nan)),
             "non-finite vel in EnvState")):
        with pytest.raises(checks.CheckError) as e:
            checks.check_state(env, bad)
        assert str(e.value) == msg


def test_assert_finite_tree_matches_reference():
    checks.assert_finite_tree({"a": torch.ones(3), "n": 3}, "ok")
    jchecks.assert_finite_tree({"a": jnp.ones(3)}, "ok")
    for tree in ({"x": np.array([1.0, np.inf])},
                 {"x": [np.ones(2), np.array([np.nan])]}):
        with pytest.raises(FloatingPointError, match="bad") as want:
            jchecks.assert_finite_tree(tree, "bad")
        with pytest.raises(FloatingPointError, match="bad") as got:
            checks.assert_finite_tree(
                jax.tree.map(torch.from_numpy, tree), "bad")
        # The same message but for the paths' notation (jax's key reprs).
        assert str(got.value).split(":")[0] == str(want.value).split(":")[0]
        assert "'x'" in str(got.value)
    st, _ = CartPole3D(CartPoleParams(), num_envs=2, device="cpu").reset(0)
    bad = st._replace(phys=st.phys._replace(sd=st.phys.sd * np.nan))
    with pytest.raises(FloatingPointError, match=r"\.phys\.sd"):
        checks.assert_finite_tree(bad, "state")


# --- sweep and plot -----------------------------------------------------------

def test_expand_grid_matches_reference():
    from cartpoleplusplus_tpu.sweep import expand_grid

    for specs in (["a.b=1,2", "c=x"], ["dqn.lr=1e-4,5e-4", "seed=0,1,2"],
                  ["only_one=7"], []):
        assert tsweep.expand_grid(specs) == expand_grid(specs)
    with pytest.raises(ValueError, match="bad grid spec"):
        tsweep.expand_grid(["novalues"])


def test_sweep_and_plot_end_to_end(tmp_path):
    """A 2-point CPU sweep of a tiny DQN run through the port's
    train.main writes 2 records with rc 0, and plot writes the sweep's
    bars and a run's curves."""
    out = str(tmp_path / "res.jsonl")
    rc = tsweep.main([
        "--out", out,
        "--base", ("--device cpu --agent dqn --num-envs 16 "
                   "--total-env-steps 32 --log-interval 1 "
                   "--dqn.hidden 8 8 --dqn.batch-size 16 "
                   "--dqn.replay-capacity-per-env 16"),
        "--grid", "seed=0,1"])
    assert rc == 0
    recs = [json.loads(x) for x in open(out)]
    assert [r["point"] for r in recs] == [0, 1]
    assert all(r["rc"] == 0 and r["final"] for r in recs)
    assert recs[0]["argv"][-2:] == ["--seed", "0"]
    bars = str(tmp_path / "s.png")
    assert tplot.main([out, "--sweep", "--key", "final.reward_mean",
                       "--out", bars]) == 0
    run_log = tmp_path / "run.jsonl"
    run_log.write_text(
        '{"env_steps": 1, "reward_mean": 0.5, "done_frac": 0.3}\n'
        '{"env_steps": 2, "reward_mean": 0.8, "done_frac": 0.1}\n')
    curves = str(tmp_path / "c.png")
    assert tplot.main([str(run_log), "--out", curves]) == 0
    for png in (bars, curves):
        assert open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    assert tplot.load_jsonl(str(run_log))[1]["reward_mean"] == 0.8
    empty = tmp_path / "empty.jsonl"
    empty.write_text("not json\n")
    assert tplot.main([str(empty)]) == 1


# --- the throughput harness ---------------------------------------------------

@pytest.mark.parametrize("continuous", [False, True],
                         ids=["discrete", "continuous"])
def test_cheap_actions_match_reference(continuous):
    """The action stream at t = 0..511 over 64 envs: bit for bit on the
    discrete env; on the continuous env the same float32 phases, and sin
    within 1 float32 ulp (XLA's CPU sin and torch's differ in the last
    bit for some arguments)."""
    p = continuous_params() if continuous else CartPoleParams()
    jp = jparams.continuous_params() if continuous \
        else jparams.CartPoleParams()
    env = CartPole3D(p, num_envs=64, device="cpu")
    jenv = JCartPole3D(jp, num_envs=64)
    fn = jax.jit(lambda t: jharness._cheap_actions(jenv, t, 64))
    for t in (0, 1, 2, 37, 255, 511):
        got = harness._cheap_actions(env, t, 64).numpy()
        want = np.asarray(fn(jnp.int32(t)))
        assert got.dtype == want.dtype and got.shape == want.shape
        if continuous:
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("obs_mode", ["pose_stack", "state"])
def test_build_rollout_checksum_matches_reference(obs_mode):
    """8 steps of 16 envs: the checksum within the env's parity bar of
    the reference's, and measure_env_steps_per_sec's keys equal to the
    reference's."""
    env = CartPole3D(CartPoleParams(), num_envs=16, obs_mode=obs_mode,
                     device="cpu")
    jenv = JCartPole3D(jparams.CartPoleParams(), num_envs=16,
                       obs_mode=obs_mode)
    st, _ = env.reset(0)
    jst, _ = jax.jit(jenv.reset)(0)
    st, acc = harness.build_rollout(env, 8)(st)
    jst, jacc = jharness.build_rollout(jenv, 8, donate=False)(jst)
    np.testing.assert_allclose(float(acc), float(jacc), rtol=ENV_RTOL,
                               atol=ENV_ATOL)
    np.testing.assert_array_equal(st.steps.numpy(), np.asarray(jst.steps))
    got = harness.measure_env_steps_per_sec(env, num_steps=2, repeats=1)
    want = jharness.measure_env_steps_per_sec(jenv, num_steps=2, repeats=1)
    assert set(got) == set(want)
    assert got["backend"] == "cpu" and got["env_steps_per_sec"] > 0
    assert got["num_envs"] == 16 and got["num_steps"] == 2


def test_tools_import_no_jax():
    """The URDF loader, the Lagrangian, the gym adapter, the checks,
    sweep, plot and the harness import neither JAX nor the JAX package
    (the GPU machine has no JAX)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mods = ("physics.urdf", "physics.lagrangian", "env.gym_adapter",
            "utils.checks", "sweep", "plot", "bench.harness")
    code = ("import sys; "
            + "; ".join(f"import cartpoleplusplus_tpu_torch.{m}"
                        for m in mods)
            + "; print(sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'cartpoleplusplus_tpu.')) or "
              "m == 'cartpoleplusplus_tpu'))")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
