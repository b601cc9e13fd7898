"""The port's env (cartpoleplusplus_tpu_torch/env) against the frozen
golden trajectories and against the JAX env on the CPU."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu.physics import params as jparams
from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch.models.from_jax import env_state_from_jax
from cartpoleplusplus_tpu_torch.physics import PhysState
from cartpoleplusplus_tpu_torch.physics.params import continuous_params
from make_golden import GOLDEN_DIR, action_pattern

PARAMS = {"discrete": CartPoleParams(), "continuous": continuous_params()}
JPARAMS = {"discrete": jparams.CartPoleParams(),
           "continuous": jparams.continuous_params()}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flat(phys):
    return torch.cat([phys.pos, phys.vel, phys.s, phys.sd], -1).numpy()


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_golden_replay(name):
    """tests/golden/*.npz replay within test_golden.py's tolerances."""
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    p = PARAMS[name]
    env = CartPole3D(p, num_envs=int(ref["num_envs"]), device="cpu")
    state, _ = env.reset(int(ref["seed"]))
    states, obs_l, rew_l, done_l = [], [], [], []
    for t in range(int(ref["num_steps"])):
        action = torch.from_numpy(action_pattern(p, t, env.num_envs))
        state, obs, reward, done, _ = env.step(state, action)
        states.append(_flat(state.phys))
        obs_l.append(obs.numpy())
        rew_l.append(reward.numpy())
        done_l.append(done.numpy())
    np.testing.assert_array_equal(np.stack(done_l), ref["dones"])
    np.testing.assert_allclose(np.stack(states), ref["states"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.stack(obs_l), ref["obs"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.stack(rew_l), ref["rewards"], rtol=1e-5,
                               atol=1e-6)


def _assert_phys_close(got, want):
    """tests/test_ops.py's 25-step tolerances: positions and tilts 2e-5,
    velocities and tilt rates 5e-4 (XLA's rsqrt and libm's trig differ
    from torch's by an ulp, and 375 substeps amplify it)."""
    for k, tol in (("pos", 2e-5), ("vel", 5e-4), ("s", 2e-5), ("sd", 5e-4)):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("obs_mode", ["pose_stack", "state"])
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_step_matches_jax(name, obs_mode):
    """25 steps of CartPole3D.step from a converted JAX state, random
    actions from a numpy seed: done and episode bookkeeping exact, floats
    within _assert_phys_close's tolerances."""
    p = PARAMS[name]
    b = 128
    jenv = JCartPole3D(JPARAMS[name], num_envs=b, obs_mode=obs_mode)
    env = CartPole3D(p, num_envs=b, obs_mode=obs_mode, device="cpu")
    jstate, jobs = jax.jit(jenv.reset)(3)
    state = env_state_from_jax(jax.device_get(jstate))
    jstep = jax.jit(jenv.step)
    rng = np.random.RandomState(5)
    for _ in range(25):
        if p.discrete_actions:
            a = rng.randint(0, 5, size=b).astype(np.int32)
        else:
            a = rng.uniform(-1.3, 1.3, size=(b, 2)).astype(np.float32)
        jstate, jobs, jrew, jdone, _ = jstep(jstate, a)
        state, obs, rew, done, _ = env.step(state, torch.from_numpy(a))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew),
                                   rtol=2e-5, atol=2e-5)
        if obs_mode == "pose_stack":
            np.testing.assert_allclose(obs.numpy(), np.asarray(jobs),
                                       rtol=2e-5, atol=2e-5)
        else:
            _assert_phys_close(PhysState(*torch.split(obs, [3, 3, 2, 2], -1)),
                               PhysState(*np.split(np.asarray(jobs),
                                                   [3, 6, 8], -1)))
    _assert_phys_close(state.phys, jax.device_get(jstate.phys))
    np.testing.assert_array_equal(state.steps.numpy(), np.asarray(jstate.steps))
    np.testing.assert_array_equal(state.episode.numpy(),
                                  np.asarray(jstate.episode))


def test_reset_matches_jax():
    """Per-env seeds and fresh states from an int seed, bit for bit seeds."""
    p = continuous_params()
    jenv = JCartPole3D(jparams.continuous_params(), num_envs=64)
    jstate, jobs = jenv.reset(11, index_offset=5)
    state, obs = CartPole3D(p, num_envs=64,
                            device="cpu").reset(11, index_offset=5)
    np.testing.assert_array_equal(state.env_seed.numpy(),
                                  np.asarray(jstate.env_seed).astype(np.int64))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(_flat(state.phys), np.concatenate(
        [np.asarray(x) for x in jstate.phys], -1), rtol=1e-6, atol=1e-7)


def test_params_equal_reference():
    """The port's copy of physics/params.py keeps the reference's fields,
    defaults and derived constants."""
    jf = [(f.name, f.default) for f in dataclasses.fields(jparams.CartPoleParams)]
    tf = [(f.name, f.default) for f in dataclasses.fields(CartPoleParams)]
    assert tf == jf
    for mk_j, mk_t in [(jparams.CartPoleParams, CartPoleParams),
                       (jparams.continuous_params, continuous_params)]:
        jp, tp = mk_j(), mk_t()
        assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
        for prop in ("half_length", "pole_inertia", "total_mass", "coupling",
                     "pole_gen_inertia", "schur_denom", "rest_penetration",
                     "tilt_s2_limit", "substeps_per_step"):
            assert getattr(jp, prop) == getattr(tp, prop), prop


def test_config_flags_equal_reference():
    """The port's copy of the flag machinery parses the same flags into the
    same values as the reference's."""
    import argparse

    from cartpoleplusplus_tpu import config as jconfig
    from cartpoleplusplus_tpu_torch import config as tconfig

    argv = ["--env.dt", "0.01", "--no-env.discrete-actions",
            "--env.max-episode-steps", "50"]
    out = []
    for cfg, cls in [(jconfig, jparams.CartPoleParams),
                     (tconfig, CartPoleParams)]:
        ap = argparse.ArgumentParser()
        cfg.add_dataclass_args(ap, cls, prefix="env.")
        args = ap.parse_args(argv)
        ap2 = argparse.ArgumentParser()
        cfg.add_dataclass_args(ap2, cls, prefix="env.")
        out.append((dataclasses.asdict(cfg.from_args(cls, args, "env.")),
                    cfg.explicit_dests(ap2, argv)))
    assert out[0] == out[1]


def test_dynamics_helpers_match_jax():
    """rest_state, apply_push_impulse and one substep with friction and
    damping switched on (the branches the presets leave off)."""
    from cartpoleplusplus_tpu.physics import dynamics as jdyn
    from cartpoleplusplus_tpu_torch.physics import dynamics as tdyn

    kw = dict(ground_friction=0.3, linear_damping=0.2, angular_damping=0.1)
    jp, tp = jparams.CartPoleParams(**kw), CartPoleParams(**kw)
    rng = np.random.RandomState(2)
    push = rng.normal(0, 1, (64, 2)).astype(np.float32)
    jst = jdyn.apply_push_impulse(jp, jdyn.rest_state(jp, (64,)), push, 0.02)
    tst = tdyn.apply_push_impulse(tp, tdyn.rest_state(tp, (64,)),
                                  torch.from_numpy(push), 0.02)
    force = rng.uniform(-12, 12, (64, 2)).astype(np.float32)
    jst = jdyn.substep(jp, jst, force, push)
    tst = tdyn.substep(tp, tst, torch.from_numpy(force),
                       torch.from_numpy(push))
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_env_defaults_to_the_card():
    """The package's env runs on the card unless the caller asks for the
    CPU: its default device is cuda (no fallback; nothing is allocated
    before reset), the same class the package exports."""
    import inspect

    import cartpoleplusplus_tpu_torch as pkg

    assert pkg.CartPole3D is CartPole3D
    sig = inspect.signature(CartPole3D.__init__)
    assert sig.parameters["device"].default == "cuda"
    assert CartPole3D(CartPoleParams()).device == torch.device("cuda")
    assert CartPole3D(CartPoleParams(), device="cpu").device.type == "cpu"
