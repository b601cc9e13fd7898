"""bfloat16 networks (`--<agent>.dtype bfloat16`) against the JAX
reference on the CPU: each of the ten nets' forward against flax's at
bfloat16, and train steps of DDPG, DQN, NAF and LRPG on state obs and of
pixel DDPG, each step restarted from the reference's state with its
replay draws injected.

The reference is flax's jit-compiled apply, which is what its train
steps run, and the port mirrors its rounding order (models/nets.py): each
product rounded to bfloat16 before its bias joins it; a Dense's sum
reaching its LayerNorm or float32 head unrounded, where XLA drops the
rounding to bfloat16 (the op-by-op apply keeps it); LayerNorm in float32
and one cast; a tanh head's tanh in float32 of its rounded sum. At
flax's init (zero biases, unit LayerNorm scales) several of those orders
agree, so the nets are also held on perturbed weights, where a wrong
order shows. What is left is the order of the float32 sums inside each
product, which flips the bfloat16 rounding of about 2e-5 of a layer's
elements; through a deep net a flip moves its row's later outputs.
"""

import contextlib
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu import agents as jagents
from cartpoleplusplus_tpu import models as jm
from cartpoleplusplus_tpu.env import pixels as jpx
from cartpoleplusplus_tpu.physics import params as jparams
from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch import agents
from cartpoleplusplus_tpu_torch.env import pixels as tpx
from cartpoleplusplus_tpu_torch.models import from_jax as fj
from cartpoleplusplus_tpu_torch.models import nets as tn
from cartpoleplusplus_tpu_torch.physics.params import continuous_params
from cartpoleplusplus_tpu_torch.utils import bf16_parity as bp
from test_torch_ddpg import DRAWS
from test_torch_pixel_ddpg import _block_indices

BF16 = torch.bfloat16
WIDE = (256, 256)          # the CLI defaults' widths
ROWS = 1024               # state rows
PIXEL_ROWS = 512          # frames
PIXELS = dict(grayscale=True, obs_uint8=True, frame_diff=True,
              frame_diff_gain=4.0)  # the pixels preset's frames
SIZES = {"conv": 16, "patch": 18}   # 18: the 6-pixel patches tile it


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _frames(size):
    """512 uint8 frames of the pixels preset's env at size x size (2
    cameras x 3 repeats, frame-diff): 128 envs' observations at env-steps
    1 to 4 after a reset under random actions, the nets' inputs in a
    pixel run."""
    env = CartPole3D(CartPoleParams(), num_envs=PIXEL_ROWS // 4,
                     obs_mode="pixels", device="cpu",
                     render_config=tpx.RenderConfig(width=size, height=size,
                                                    **PIXELS))
    st, _ = env.reset(0)
    g = torch.Generator().manual_seed(0)
    out = []
    for _ in range(4):
        a = torch.randint(0, 5, (env.num_envs,), generator=g,
                          dtype=torch.int32)
        st, obs, *_ = env.step(st, a)
        out.append(obs)
    return torch.cat(out).numpy()


def _inputs(pixel, encoder, action):
    rng = np.random.RandomState(0)
    x = (_frames(SIZES[encoder]) if pixel
         else rng.normal(0, 1, (ROWS, 42)).astype(np.float32))
    act = rng.uniform(-1, 1, (len(x), 2)).astype(np.float32)
    return (x, act) if action else (x,)


# name: (flax class, port class, state-dict bridge, outputs, takes action)
NETS = {
    "actor": (jm.ActorMLP, tn.ActorMLP, fj.actor_state_dict, 2, False),
    "critic": (jm.CriticMLP, tn.CriticMLP, fj.critic_state_dict, 2, True),
    "qnet": (jm.QNetMLP, tn.QNetMLP, fj.qnet_state_dict, 5, False),
    "policy": (jm.PolicyMLP, tn.PolicyMLP, fj.policy_state_dict, 5, False),
    "naf": (jm.NafNet, tn.NafNet, fj.naf_state_dict, 2, True),
    "visual_actor": (jm.VisualActor, tn.VisualActor,
                     fj.visual_actor_state_dict, 2, False),
    "visual_critic": (jm.VisualCritic, tn.VisualCritic,
                      fj.visual_critic_state_dict, 2, True),
    "visual_qnet": (jm.VisualQNet, tn.VisualQNet, fj.visual_qnet_state_dict,
                    5, False),
    "visual_policy": (jm.VisualPolicy, tn.VisualPolicy,
                      fj.visual_policy_state_dict, 5, False),
    "visual_naf": (jm.VisualNafNet, tn.VisualNafNet,
                   fj.visual_naf_state_dict, 2, True),
}
CASES = [(n, "conv") for n in NETS] + [
    (n, "patch") for n in NETS if n.startswith("visual")]


@functools.lru_cache(maxsize=None)
def _flax(name, encoder):
    """The flax net at bfloat16, its init's parameters, its jit-compiled
    apply and its inputs."""
    jcls, *_ = NETS[name]
    pixel = name.startswith("visual")
    kw = dict(encoder=encoder) if pixel else {}
    jnet = jcls(hidden=WIDE, dtype=jnp.bfloat16, **kw)
    args = _inputs(pixel, encoder, NETS[name][4])
    params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(1),
                                               *(a[:1] for a in args)))
    return params, jax.jit(jnet.apply), args


def _forward(name, encoder, variant):
    """(port's outputs, flax's jit-compiled outputs, the inputs, the
    port's net) of net `name` at bfloat16 from the same parameters:
    flax's init, or ("perturbed") its init plus N(0, 0.05) on every
    parameter, on the env's frames, or ("random") on uniform random uint8
    frames."""
    _, cls, to_sd, n_out, _ = NETS[name]
    params, apply, args = _flax(name, encoder)
    rng = np.random.RandomState(7)
    if variant == "random":
        args = (rng.randint(0, 256, args[0].shape).astype(np.uint8),) \
            + args[1:]
    if variant == "perturbed":
        params = jax.tree.map(lambda x: (x + rng.normal(
            0, bp.PERTURB_STD, x.shape)).astype(np.float32), params)
    pixel = name.startswith("visual")
    kw = dict(encoder=encoder) if pixel else {}
    net = cls(args[0].shape[1:] if pixel else 42, n_out, WIDE, dtype=BF16,
              **kw)
    net.load_state_dict(to_sd(params, WIDE))
    want = tuple(np.asarray(w) for w in _tuple(apply(params, *args)))
    with torch.no_grad():
        got = _tuple(net(*(torch.from_numpy(a) for a in args)))
    return got, want, args, net


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("name,encoder", CASES,
                         ids=[f"{n}-{e}" for n, e in CASES])
def test_bf16_forward_matches_flax(name, encoder):
    """Each net at bfloat16 from flax's init at (256, 256) (the pixel nets
    on the pixels preset's frames, conv at 16 x 16 and patch at 18 x 18):
    every output float32 and inside bf16_parity.TIGHT of flax's: each
    element within one bfloat16 ulp of the output's magnitude (NAF's q, a
    float32 sum of v and the quadratic form, of v's and the form's
    magnitudes together), and at most 0.5 % of the elements off the
    float32 nets' bar (rtol 1e-5 / atol 1e-6) at all (NAF's q: 6 x 0.5 %,
    one share per bfloat16 head output it sums)."""
    got, want, *_ = _forward(name, encoder, "init")
    assert all(g.dtype == torch.float32 for g in got)
    errors = bp.output_errors(got, want, naf=name.endswith("naf"))
    assert bp.within(errors, bp.TIGHT, naf=name.endswith("naf")), errors


DEEP_CASES = [(n, e, "perturbed") for n, e in CASES] + [
    (n, e, "random") for n, e in CASES if n.startswith("visual")]


@pytest.mark.parametrize("name,encoder,variant", DEEP_CASES,
                         ids=[f"{n}-{e}-{v}" for n, e, v in DEEP_CASES])
def test_bf16_forward_matches_flax_any_weights_and_frames(name, encoder,
                                                         variant):
    """Each net at bfloat16 from perturbed weights (flax's init plus
    N(0, 0.05): biases and LayerNorm scales off their init), and each
    pixel net on random frames, inside bf16_parity.DEEP of flax's (4
    ulps, 10 % of elements; measured on the CPU at most 2 ulps and 1.2 %).
    On the perturbed weights the planted rounding-order fault (each Dense
    one product and bias rounded once, bf16_parity.fused_bias) falls
    outside it (measured 44 % and more of some output of every net)."""
    naf = name.endswith("naf")
    got, want, args, net = _forward(name, encoder, variant)
    errors = bp.output_errors(got, want, naf=naf)
    assert bp.within(errors, bp.DEEP, naf=naf), errors
    if variant == "perturbed":
        with torch.no_grad(), bp.fused_bias():
            bad = _tuple(net(*(torch.from_numpy(a) for a in args)))
        errors = bp.output_errors(bad, want, naf=naf)
        assert not bp.within(errors, bp.DEEP, naf=naf), errors


def test_flax_keeps_bf16_parameters_float32():
    """flax's bfloat16 nets hold float32 parameters (param_dtype) in the
    float32 nets' tree: models/from_jax.py's bridges take them unchanged,
    and the port's bfloat16 nets hold float32 Parameters too."""
    for name, encoder in CASES:
        jcls, cls, to_sd, n_out, _ = NETS[name]
        pixel = name.startswith("visual")
        kw = dict(encoder=encoder) if pixel else {}
        args = tuple(a[:1] for a in _inputs(pixel, encoder, NETS[name][4]))
        trees = [jax.eval_shape(jcls(hidden=(8, 8), dtype=dt, **kw).init,
                                jax.random.PRNGKey(0), *args)
                 for dt in (jnp.bfloat16, jnp.float32)]
        assert trees[0] == trees[1]
        assert all(x.dtype == np.float32 for x in jax.tree.leaves(trees[0]))
        net = cls(args[0].shape[1:] if pixel else 42, n_out, (8, 8),
                  dtype=BF16, **kw)
        net.load_state_dict(to_sd(jax.tree.map(
            lambda x: np.zeros(x.shape, x.dtype), trees[0]), (8, 8)))
        assert all(p.dtype == torch.float32 for p in net.parameters())


def test_float32_nets_are_unchanged_by_dtype():
    """dtype=float32 is the nets' former path, bit for bit: the Linear
    itself (bias in the product), LayerNorm in float32."""
    g = torch.Generator().manual_seed(0)
    net = tn.NafNet(42, 2, (16, 16), generator=g)
    x, a = torch.randn(64, 42, generator=g), torch.randn(64, 2, generator=g)
    with torch.no_grad():
        h = x
        for layer, norm in zip(net.torso, net.norms):
            h = torch.relu(norm(layer(h)))
        out = net.head(h)
        q, mu, v = net(x, a)
    assert torch.equal(v, out[..., 0])
    assert torch.equal(mu, torch.tanh(out[..., 1:3]))


# --- train steps ----------------------------------------------------------------

SMALL = dict(hidden=(32, 32), rollout_steps=4, updates_per_step=2,
             batch_size=32, replay_capacity_per_env=16, warmup_env_steps=0)
RENDER = dict(width=16, height=16, **PIXELS)
# (reference agent, port agent, continuous, config, bridge, [(port
# field, reference field, state-dict bridge, lr)], loss keys, pixels)
AGENTS = {
    "ddpg": (jagents.DDPG, agents.DDPG, True, SMALL, fj.ddpg_state_from_jax,
             [("actor", "actor", fj.actor_state_dict, 1e-4),
              ("critic", "critic", fj.critic_state_dict, 1e-3)],
             ("critic_loss", "actor_loss"), False),
    "dqn": (jagents.DQN, agents.DQN, False, dict(SMALL, lr=1e-3),
            fj.dqn_state_from_jax, [("q", "q", fj.qnet_state_dict, 1e-3)],
            ("loss",), False),
    "naf": (jagents.NAF, agents.NAF, True, SMALL, fj.naf_state_from_jax,
            [("net", "params", fj.naf_state_dict, 5e-4)], ("loss",), False),
    "lrpg": (jagents.LRPG, agents.LRPG, False,
             dict(hidden=(32, 32), rollout_steps=4), fj.lrpg_state_from_jax,
             [("policy", "params", fj.policy_state_dict, 3e-4)],
             ("loss",), False),
    "pixel_ddpg": (jagents.DDPG, agents.DDPG, True,
                   dict(hidden=(32, 32), batch_size=16,
                        replay_capacity_per_env=16, rollout_steps=2,
                        updates_per_step=2, warmup_env_steps=2,
                        sample="block"), fj.ddpg_state_from_jax,
                   [("actor", "actor", fj.visual_actor_state_dict, 1e-4),
                    ("critic", "critic", fj.visual_critic_state_dict, 1e-3)],
                   ("critic_loss", "actor_loss"), True),
}
TF_STEPS = 3
LOSS_RTOL = 2e-2
PARAM_RTOL = 2e-2          # and atol 2 lr: Adam's first steps move an
PARAM_OFF_SHARE = 5e-3     # element by about lr whatever its gradient
# The update a step makes, against the reference's: per parameter,
# |d_port - d_ref| / |d_ref| (measured at most 0.079, pixel DDPG's actor;
# with the gradients flipped at least 0.58, a zeroed update 1), and over
# a net the share of elements the reference moved by more than lr / 2
# that the port moved the other way (measured at most 0.0014).
UPDATE_REL = 0.2
UPDATE_SIGN_OFF = 0.02


def _bf16_agents(name):
    jcls, cls, continuous, cfg, *_, pixels = AGENTS[name]
    b = 16 if pixels else 64
    kw = {}
    if pixels:
        kw = dict(obs_mode="pixels")
    jenv = JCartPole3D(jparams.continuous_params() if continuous
                       else jparams.CartPoleParams(), num_envs=b,
                       render_config=(jpx.RenderConfig(**RENDER) if pixels
                                      else None), **kw)
    env = CartPole3D(continuous_params() if continuous else CartPoleParams(),
                     num_envs=b, device="cpu",
                     render_config=(tpx.RenderConfig(**RENDER) if pixels
                                    else None), **kw)
    ref = jcls(jenv, _config(jcls, cfg))
    port = cls(env, _config(cls, cfg))
    return ref, port


def _config(cls, cfg):
    mod = jagents if cls.__module__.startswith("cartpoleplusplus_tpu.") \
        else agents
    cfg_cls = getattr(mod, cls.__name__ + "Config")
    return cfg_cls(learner="xla", dtype="bfloat16", **cfg)


def _params(st, nets):
    """{field: {name: float32 numpy}} of the port state's networks."""
    return {f: {k: v.detach().numpy().copy()
                for k, v in getattr(st, f).state_dict().items()}
            for f, *_ in nets}


def update_errors(moved, ref_moved, lr):
    """(largest |d - d_ref| / |d_ref| over the parameters, share of the
    elements with |d_ref| > lr / 2 that d moves the other way) of one
    net's update `moved` against the reference's `ref_moved`, both
    {name: array}. A parameter the reference left alone must stay put."""
    rel, off, n = 0.0, 0, 0
    for k, b in ref_moved.items():
        a = moved[k]
        norm = np.linalg.norm(b)
        rel = max(rel, np.linalg.norm(a - b) / norm if norm > 0
                  else float(np.abs(a).max() > 0) * np.inf)
        big = np.abs(b) > lr / 2
        off += int((np.sign(a[big]) != np.sign(b[big])).sum())
        n += int(big.sum())
    return rel, off / max(n, 1)


def update_ok(moved, ref_moved, lr):
    rel, off = update_errors(moved, ref_moved, lr)
    return rel <= UPDATE_REL and off <= UPDATE_SIGN_OFF


@contextlib.contextmanager
def _flipped_gradients(port):
    """The port's learner with every gradient negated before Adam."""
    mod = sys.modules[type(port).__module__]
    adam = mod.adam_update
    mod.adam_update = lambda net, grads, opt, lr: adam(
        net, [-g for g in grads], opt, lr)
    try:
        yield
    finally:
        mod.adam_update = adam


def bf16_teacher_forced(name):
    """3 train steps of agent `name` at bfloat16, each from the
    reference's state through the bridge with the reference's replay
    draws, the plain rollout and learner: the losses within rtol 2e-2;
    every network within rtol 2e-2 / atol 2 lr of the reference's but for
    at most 0.5 % of its elements; each step's update against the
    reference's (update_ok), a bar that the same step with its gradients
    flipped, and an update of zero, both fail wherever the reference
    moved; parameters and Adam moments float32."""
    ref, port = _bf16_agents(name)
    *_, bridge, nets, loss_keys, pixels = AGENTS[name]
    assert not port.kernel_mode and not port.kernel_learner_ok()
    jstep = jax.jit(ref.train_step)
    jst = ref.init(0)
    c = ref.cfg
    updated = 0
    for step in range(TF_STEPS):
        host = jax.device_get(jst)
        kw = {}
        if pixels:
            kw["indices"] = _block_indices(ref, host)
        elif hasattr(c, "sample"):
            cap = ref.replay.capacity
            filled = min(int(host.replay.filled) + c.rollout_steps, cap)
            cursor = (int(host.replay.cursor) + c.rollout_steps) % cap
            kw["indices"] = DRAWS[c.sample](ref, jst, c.updates_per_step,
                                            filled, cursor)
        pst, m = port.train_step(bridge(port, host), **kw)
        with _flipped_gradients(port):
            flipped, _ = port.train_step(bridge(port, host), **kw)
        jst, jm_ = jstep(jst)
        assert m["learner_impl"] == 0.0
        for key in loss_keys:
            np.testing.assert_allclose(float(m[key]), float(jm_[key]),
                                       rtol=LOSS_RTOL,
                                       err_msg=f"step {step + 1} {key}")
        got, bad = _params(pst, nets), _params(flipped, nets)
        for field, jfield, to_sd, lr in nets:
            start = {k: v.numpy() for k, v in
                     to_sd(getattr(host, jfield), (32, 32)).items()}
            want = {k: v.numpy() for k, v in to_sd(
                getattr(jax.device_get(jst), jfield), (32, 32)).items()}
            off = n = 0
            for key, p in getattr(pst, field).state_dict().items():
                assert p.dtype == torch.float32
                a, b = got[field][key], want[key]
                off += int((np.abs(a - b) > 2 * lr
                            + PARAM_RTOL * np.abs(b)).sum())
                n += a.size
            assert off <= PARAM_OFF_SHARE * n, (step + 1, field, off, n)
            ref_moved = {k: want[k] - start[k] for k in want}
            moved = {k: got[field][k] - start[k] for k in want}
            assert update_ok(moved, ref_moved, lr), (
                step + 1, field, update_errors(moved, ref_moved, lr))
            if any(np.any(d) for d in ref_moved.values()):
                updated += 1
                flip = {k: bad[field][k] - start[k] for k in want}
                zero = {k: np.zeros_like(d) for k, d in ref_moved.items()}
                assert not update_ok(flip, ref_moved, lr), (step + 1, field)
                assert not update_ok(zero, ref_moved, lr), (step + 1, field)
        opts = [v for k, v in pst._asdict().items() if k.endswith("opt")]
        assert opts and all(x.dtype == torch.float32 for o in opts
                            for x in o.mu + o.nu)
    assert updated >= len(nets) * (TF_STEPS - 1)


@pytest.mark.parametrize("name", [n for n in AGENTS if not AGENTS[n][-1]])
def test_bf16_train_steps_track_jax_teacher_forced(name):
    """bf16_teacher_forced for DDPG, DQN, NAF and LRPG on state obs
    (pixel DDPG: tests/test_torch_bf16_pixels.py)."""
    bf16_teacher_forced(name)


@pytest.mark.parametrize("name", ["ddpg", "dqn", "naf", "lrpg"])
def test_bf16_checkpoint_has_the_float32_layout(name):
    """A bfloat16 agent's checkpoint tree has the float32 agent's keys,
    shapes and dtypes (parameters, Adam moments, targets and replay
    float32), and a float32 run's checkpoint restores into the bfloat16
    agent unchanged."""
    from cartpoleplusplus_tpu_torch.ckpt.checkpoint import (merge_restored,
                                                            to_tree)

    continuous, cfg = AGENTS[name][2:4]
    trees = []
    for dtype in ("bfloat16", "float32"):
        env = CartPole3D(continuous_params() if continuous
                         else CartPoleParams(), num_envs=16, device="cpu")
        cls = AGENTS[name][1]
        agent = cls(env, getattr(agents, cls.__name__ + "Config")(
            dtype=dtype, **cfg))
        st = agent.init(0)
        trees.append((st, to_tree(st)))

    def layout(tree):
        return jax.tree.map(lambda x: (tuple(x.shape), x.dtype)
                            if isinstance(x, torch.Tensor) else type(x),
                            tree)

    assert layout(trees[0][1]) == layout(trees[1][1])
    got = to_tree(merge_restored(trees[0][0], trees[1][1]))
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0,
                                                         atol=0)
                 if isinstance(a, torch.Tensor) else None,
                 {k: v for k, v in got.items() if k != "rng"},
                 {k: v for k, v in trees[1][1].items() if k != "rng"})
