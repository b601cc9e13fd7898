"""The port's pixel observations (env/cartpole.py's pixel mode), the pixel
encoders and Visual* nets (models/nets.py), and the quantized replay ring
with block sampling (agents/replay.py), against the JAX reference on the
CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu.agents.replay import ReplayBuffer as JReplayBuffer
from cartpoleplusplus_tpu.env import pixels as jpx
from cartpoleplusplus_tpu.models import nets as jnets
from cartpoleplusplus_tpu.physics import params as jparams
from cartpoleplusplus_tpu_torch import CartPole3D
from cartpoleplusplus_tpu_torch.agents import ReplayBuffer
from cartpoleplusplus_tpu_torch.env import pixels as tpx
from cartpoleplusplus_tpu_torch.models import (PatchEncoder, PixelEncoder,
                                               VisualActor, VisualCritic)
from cartpoleplusplus_tpu_torch.models.from_jax import (
    encoder_state_dict, env_state_from_jax, visual_actor_from_flax,
    visual_critic_from_flax)
from cartpoleplusplus_tpu_torch.physics.params import continuous_params

MODES = {"raw_rgb": dict(),
         "uint8_gray": dict(grayscale=True, obs_uint8=True),
         "diff_gray": dict(grayscale=True, obs_uint8=True, frame_diff=True,
                           frame_diff_gain=4.0),
         "diff_float_rgb": dict(frame_diff=True, frame_diff_gain=4.0)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(2)


def _envs(mode, b=8, n=16):
    kw = dict(width=n, height=n, **MODES[mode])
    jenv = JCartPole3D(jparams.continuous_params(), num_envs=b,
                       obs_mode="pixels",
                       render_config=jpx.RenderConfig(**kw))
    env = CartPole3D(continuous_params(), num_envs=b, obs_mode="pixels",
                     render_config=tpx.RenderConfig(**kw))
    return jenv, env


def _assert_obs_close(got, want, uint8):
    assert got.shape == want.shape
    if uint8:
        assert got.dtype == torch.uint8 and want.dtype == np.uint8
        diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, diff.max()
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pixel_env_steps_match_jax(mode):
    """Three env-steps from the reference's reset state, the same actions:
    frames within 1e-5 (float) or one level (uint8), reward and done
    exact, the reset observation the reference's (op by op: the reference
    runs under jax.disable_jit, as test_torch_render.py explains)."""
    jenv, env = _envs(mode)
    uint8 = env.render_config.obs_uint8
    assert env.obs_shape == jenv.obs_shape and env.obs_size == jenv.obs_size
    with jax.disable_jit():
        jstate, jobs = jenv.reset(3)
        _assert_obs_close(env._reset_obs_pixels(),
                          np.asarray(jenv._reset_obs_pixels()), uint8)
    state = env_state_from_jax(jax.device_get(jstate))
    obs0 = env._initial_obs(state.phys)
    _assert_obs_close(obs0, np.asarray(jobs), uint8)
    assert bool((obs0 == obs0[:1]).all())  # the reset pose is deterministic
    rng = np.random.RandomState(4)
    for _ in range(3):
        a = rng.uniform(-1.2, 1.2, size=(8, 2)).astype(np.float32)
        with jax.disable_jit():
            jstate, jobs, jrew, jdone, _ = jenv.step(jstate, jnp.asarray(a))
        state, obs, rew, done, _ = env.step(state, torch.from_numpy(a))
        _assert_obs_close(obs, np.asarray(jobs), uint8)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=2e-5,
                                   atol=2e-5)


def test_pixel_env_reset_select_uses_the_constant_frame():
    """A finished env's next observation is the constant reset frame, a
    live env's the rendered stack (uint8 frame-diff, 16 x 16)."""
    _, env = _envs("diff_gray")
    state, _ = env.reset(0)
    for _ in range(80):
        state, obs, _, done, info = env.step(state, torch.zeros((8, 2)))
        if bool(done.any()):
            break
    assert bool(done.any())
    reset = env._reset_obs_pixels()[0]
    assert all(torch.equal(obs[i], reset) for i in range(8) if done[i])
    assert any(not torch.equal(info["terminal_obs"][i], reset)
               for i in range(8) if done[i])


def test_pixel_env_renders_every_frame_through_the_wrapper(monkeypatch):
    """Every frame the env draws goes through ops.render_kernel.render (B10,
    or B11 under CARTPOLE_RENDER_CULL=1, on the card): the reset's 8 envs,
    one render per step of its 3 repeat snapshots, and the constant reset
    frame once at batch 1, cached over later steps."""
    from cartpoleplusplus_tpu_torch.ops import render_kernel as trk

    draw, sizes = trk.render, []

    def spy(p, cfg, phys):
        sizes.append(phys.pos.shape[0])
        return draw(p, cfg, phys)

    monkeypatch.setattr(trk, "render", spy)
    _, env = _envs("diff_gray")
    state, _ = env.reset(0)
    for _ in range(2):
        state, *_ = env.step(state, torch.zeros((8, 2)))
    assert sizes == [8, 24, 1, 24]


def _images(shape, seed, uint8):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    return (x * 255).astype(np.uint8) if uint8 else x


def _perturb(tree, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: jnp.asarray(
        (np.asarray(x) + rng.normal(0, scale, x.shape)).astype(np.float32)),
        tree)


@pytest.mark.parametrize("uint8", [False, True])
@pytest.mark.parametrize("shape", [(16, 16, 6), (48, 48, 6), (25, 18, 2)])
def test_pixel_encoder_matches_flax(shape, uint8):
    """PixelEncoder's 'SAME' stride-2 convs (0 before, 1 after on even
    sizes), its (H, W, C) flatten and its uint8 scaling, from flax
    params."""
    img = _images((5,) + shape, 1, uint8)
    jenc = jnets.PixelEncoder((8, 16, 4))
    params = _perturb(jenc.init(jax.random.PRNGKey(0), img[:1]), 2)
    enc = PixelEncoder(shape, (8, 16, 4))
    enc.load_state_dict(encoder_state_dict(
        {"PixelEncoder_0": jax.device_get(params)["params"]}))
    with torch.no_grad():
        got = enc(torch.from_numpy(img)).numpy()
    want = np.asarray(jenc.apply(params, img))
    assert got.shape == want.shape == (5, enc.out_dim)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("uint8", [False, True])
def test_patch_encoder_matches_flax(uint8):
    img = _images((4, 48, 48, 6), 3, uint8)
    jenc = jnets.PatchEncoder()
    params = _perturb(jenc.init(jax.random.PRNGKey(0), img[:1]), 4)
    enc = PatchEncoder((48, 48, 6))
    enc.load_state_dict(encoder_state_dict(
        {"PatchEncoder_0": jax.device_get(params)["params"]}))
    with torch.no_grad():
        got = enc(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, np.asarray(jenc.apply(params, img)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("encoder", ["conv", "patch"])
@pytest.mark.parametrize("uint8", [False, True])
def test_visual_nets_match_flax(encoder, uint8):
    """VisualActor and VisualCritic from flax params on float and uint8
    frames; the init draws the port's own weights of the same shapes."""
    shape, hidden, feats = (24, 24, 6), (32, 32), (8, 16, 8)
    img = _images((6,) + shape, 5, uint8)
    act = np.random.RandomState(6).uniform(-1, 1, (6, 2)).astype(np.float32)
    ja = jnets.VisualActor(hidden=hidden, features=feats, encoder=encoder)
    jc = jnets.VisualCritic(hidden=hidden, features=feats, encoder=encoder)
    pa = _perturb(ja.init(jax.random.PRNGKey(0), img[:1]), 7)
    pc = _perturb(jc.init(jax.random.PRNGKey(1), img[:1], act[:1]), 8)
    actor = visual_actor_from_flax(jax.device_get(pa), shape, 2, hidden,
                                   feats, encoder)
    critic = visual_critic_from_flax(jax.device_get(pc), shape, 2, hidden,
                                     feats, encoder)
    with torch.no_grad():
        a = actor(torch.from_numpy(img)).numpy()
        q = critic(torch.from_numpy(img), torch.from_numpy(act)).numpy()
    np.testing.assert_allclose(a, np.asarray(ja.apply(pa, img)), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(q, np.asarray(jc.apply(pc, img, act)),
                               rtol=1e-4, atol=1e-5)
    fresh = VisualActor(shape, 2, hidden, feats, encoder,
                        generator=torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in fresh.state_dict().items()} == \
        {k: v.shape for k, v in actor.state_dict().items()}
    critic_fresh = VisualCritic(shape, 2, hidden, feats, encoder)
    assert critic_fresh.state_dict().keys() == critic.state_dict().keys()


def _pixel_rings(b=8, capacity=16, shape=(4, 4, 3)):
    jrb = JReplayBuffer(num_envs=b, capacity_per_env=capacity,
                        obs_shape=shape, quantize_obs=True, action_dim=2,
                        discrete=False)
    rb = ReplayBuffer(b, capacity, 0, 2, obs_shape=shape, quantize_obs=True)
    return jrb, rb


def _fill(jrb, rb, t, seed, chunks):
    """`chunks` inserts of t steps of float frames (quantized on insert)."""
    rng = np.random.RandomState(seed)
    jrs, rs = jrb.init(), rb.init()
    b = rb.num_envs
    for _ in range(chunks):
        chunk = (rng.uniform(0, 1, (t, b) + rb.obs_shape).astype(np.float32),
                 rng.normal(size=(t, b, 2)).astype(np.float32),
                 rng.normal(size=(t, b)).astype(np.float32),
                 rng.uniform(size=(t, b)) < 0.2)
        jrs = jrb.add_trajectory(jrs, *(jnp.asarray(x) for x in chunk))
        rs = rb.add_trajectory(rs, *(torch.from_numpy(x) for x in chunk))
    return jrs, rs


@pytest.mark.parametrize("t", [4, 6, 24])
def test_quantized_ring_insert_matches_jax(t):
    """The flat uint8 ring (B, C, H*W*ch): aligned and wrapping inserts
    of float frames equal the reference's, cursor and fill too."""
    jrb, rb = _pixel_rings()
    jrs, rs = _fill(jrb, rb, t, seed=t, chunks=3)
    assert rs.obs.dtype == torch.uint8 and rs.obs.shape == (8, 16, 48)
    assert (rs.cursor, rs.filled) == (int(jrs.cursor), int(jrs.filled))
    for name in ("obs", "action", "reward", "done"):
        np.testing.assert_array_equal(getattr(rs, name).numpy(),
                                      np.asarray(getattr(jrs, name)))


@pytest.mark.parametrize("t,chunks", [(4, 3), (6, 5)])
def test_presample_block_matches_jax(t, chunks):
    """presample_block with the reference's draws injected (indices = (slots,
    offs)) gives the reference's K block minibatches, from an aligned ring
    and from one whose cursor has wrapped; the frames stay uint8 (the
    reference's decode=False) in frame shape."""
    jrb, rb = _pixel_rings()
    jrs, rs = _fill(jrb, rb, t, seed=1, chunks=chunks)
    keys = jax.random.split(jax.random.PRNGKey(9), 5)
    want = jrb.presample_block(jrs, keys, 4, decode=False)
    n_valid = max(int(jrs.filled) - 1, 1)
    slots, offs = [], []
    for key in keys:
        k_slot, k_env = jax.random.split(key)
        age = int(jax.random.randint(k_slot, (), 1, n_valid + 1))
        slots.append((int(jrs.cursor) - 1 - age) % rb.capacity)
        offs.append(4 * int(jax.random.randint(k_env, (), 0, 2)))
    got = rb.presample_block(rs, 4, 5, indices=(slots, offs))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.uint8
    own = rb.presample_block(rs, 4, 64, generator=torch.Generator()
                             .manual_seed(0))
    assert own[0].shape == (64, 4, 4, 4, 3)
    with pytest.raises(ValueError, match="batch_size"):
        rb.presample_block(rs, 3, 2)
