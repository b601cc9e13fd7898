"""How far a bfloat16 net's outputs sit from another run of the same net
(flax's jit-compiled apply on the CPU, or the port's net on another
device), the bars they are held to, and the rounding-order fault those
bars must catch.

An output's error is measured two ways: its largest error in bfloat16
ulps of the output's magnitude (8 significant bits), and the share of its
elements off the float32 nets' bar (rtol 1e-5 / atol 1e-6). NAF's q is
the float32 sum of v and the quadratic form, so its magnitude is theirs
together.

Three bars, each set between the largest sound reading and the
smallest reading of the planted fault below (the fault's reading is the
largest share of any one output of a net, the smallest over the nets):

  * TIGHT, one ulp and 0.5 % of the elements (NAF's q: 6 x 0.5 %, one
    share per bfloat16 head output it sums): against flax at its init on
    the env's frames, where the rounding order alone is at stake, and a
    state net on the card against the CPU at 4096 rows (sound at most
    0.79 ulps and 0.44 %, NAF's q; the fault 73 % and more);
  * DEEP, 4 ulps and 10 %: against flax on perturbed weights and random
    frames (sound at most 2 ulps and 1.2 %, the fault 59 % and more);
  * PIXEL_CARD, 4 ulps and 40 %: a pixel net on the card against the CPU
    at 4096 rows of 48 x 48 frames (sound at most 2.5 ulps and 21.5 %,
    the fault 63 % and more). A product's float32 sums in another order
    flip its bfloat16 rounding in a few elements in 1e5, and through the
    convolutions a flip moves its row's later outputs.

(Readings on NVIDIA H100 80GB HBM3 and on the CPU with torch 2.11.)

`fused_bias` plants the fault: each bfloat16 Dense as one product with
its bias, rounded once (torch's addmm), the order flax's Dense does not
use. With zero biases (flax's and the port's init) the two orders agree,
so a check that must see it runs on `perturb`ed weights.
"""

from __future__ import annotations

import contextlib
import copy
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..models import nets

F32_RTOL, F32_ATOL = 1e-5, 1e-6
NAF_Q_TERMS = 6           # v, mu (2) and the L entries (3)
TIGHT = (1.0, 5e-3)       # (ulps, share of elements off)
DEEP = (4.0, 0.10)
PIXEL_CARD = (4.0, 0.40)
PERTURB_STD = 0.05


def ulps(err: float, magnitude: float) -> float:
    """`err` in bfloat16 ulps at `magnitude`."""
    if magnitude == 0.0:
        return 0.0 if err == 0.0 else math.inf
    return err / 2.0 ** (math.floor(math.log2(magnitude)) - 7)


def _numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        assert x.dtype == torch.float32, x.dtype
        return x.numpy().astype(np.float64)
    return np.asarray(x, dtype=np.float64)


def output_errors(got, want, naf: bool = False) -> list:
    """[(max error in ulps of the output's magnitude, share of elements
    off the float32 bar)] per output of `got` against `want` (a tensor or
    array, or tuples of them; NAF's (q, mu, v) when `naf`)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    got, want = [_numpy(g) for g in got], [_numpy(w) for w in want]
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        mag = float(np.abs(w).max())
        if naf and i == 0:
            mag = float(np.abs(want[2]).max() + np.abs(w - want[2]).max())
        err = np.abs(g - w)
        out.append((ulps(float(err.max()), mag),
                    float((err > F32_ATOL + F32_RTOL * np.abs(w)).mean())))
    return out


def within(errors, bar, naf: bool = False) -> bool:
    """Whether every output of `errors` (output_errors) is inside `bar`
    (TIGHT, DEEP or PIXEL_CARD); under TIGHT, NAF's q takes NAF_Q_TERMS
    x the share."""
    max_ulps, share = bar
    for i, (u, off) in enumerate(errors):
        terms = NAF_Q_TERMS if naf and i == 0 and bar == TIGHT else 1
        if u > max_ulps or off > share * terms:
            return False
    return True


def is_naf(net) -> bool:
    return isinstance(getattr(net, "mlp", net), nets.NafNet)


@torch.no_grad()
def perturb(net, generator, std: float = PERTURB_STD):
    """Add N(0, std) to every parameter of `net` (biases and LayerNorm
    scales off their init), in place; returns `net`."""
    for p in net.parameters():
        p.add_(torch.randn(p.shape, generator=generator) * std)
    return net


@contextlib.contextmanager
def fused_bias():
    """The nets with each bfloat16 Dense one product and bias rounded
    once: the rounding-order fault."""
    dense = nets.dense

    def fused(layer, x, dtype=torch.float32):
        if dtype == torch.float32:
            return layer(x)
        return F.linear(x.to(dtype), layer.weight.to(dtype),
                        layer.bias.to(dtype))

    nets.dense = fused
    try:
        yield
    finally:
        nets.dense = dense


NETS = {"actor": nets.ActorMLP, "critic": nets.CriticMLP,
        "qnet": nets.QNetMLP, "policy": nets.PolicyMLP, "naf": nets.NafNet,
        "visual_actor": nets.VisualActor, "visual_critic": nets.VisualCritic,
        "visual_qnet": nets.VisualQNet, "visual_policy": nets.VisualPolicy,
        "visual_naf": nets.VisualNafNet}


def takes_action(name: str) -> bool:
    return name.endswith(("critic", "naf"))


def bf16_net(name: str, obs_shape=42, seed: int = 0,
             hidden=(256, 256)):
    """The bfloat16 net `name` of NETS (a pixel net on the conv encoder
    over `obs_shape`) from a seeded generator, its weights perturbed."""
    g = torch.Generator().manual_seed(seed)
    n_out = 5 if name.endswith(("qnet", "policy")) else 2
    net = NETS[name](obs_shape, n_out, hidden, generator=g,
                     dtype=torch.bfloat16)
    return perturb(net, g)


def card_vs_cpu(name: str, dev, frames, rows: int = 4096):
    """Net `name` (bf16_net, seeded by its name's length) on `rows` rows
    (a pixel net on `frames`, uint8 pixel observations) on the card `dev`
    against the same net on the CPU: (its output_errors, its bar, the
    output_errors of the net with the fault planted on the card)."""
    g = torch.Generator().manual_seed(len(name))
    pixel = name.startswith("visual")
    x = (frames[:rows].cpu() if pixel
         else torch.randn(rows, 42, generator=g))
    args = (x,)
    if takes_action(name):
        args += (torch.rand(rows, 2, generator=g) * 2 - 1,)
    net = bf16_net(name, tuple(x.shape[1:]) if pixel else 42, len(name))
    card = copy.deepcopy(net).to(dev)
    on_card = tuple(a.to(dev) for a in args)
    with torch.no_grad():
        want = net(*args)
        got = card(*on_card)
        with fused_bias():
            bad = card(*on_card)
    naf = is_naf(net)
    return (output_errors(got, want, naf), PIXEL_CARD if pixel else TIGHT,
            output_errors(bad, want, naf))
