"""The initial weights of a run, made on the device from the run's seed.

One normal draw per net from a torch.Generator on the run's device, cut
into the net's leaves and scaled by their kind: "dense" weights by
1/sqrt(fan-in) (LeCun's normal), "small" heads by 1e-3, biases zero and
LayerNorm scales one. The program under test and the reference are both
handed these tensors, and both start Adam from a second moment of ADAM_V0
in every element (first moments zero): from zero second moments Adam's
first update is lr x sign(g) in every element, so a gradient element that
is zero to rounding takes a full step either way, and the two sides part by
far more than rounding (PERF.md, §6, PR 21).
"""

from __future__ import annotations

import math

import torch

SMALL_HEAD = 1e-3
ADAM_V0 = 1e-4


def make(shapes: dict, seed: int, device) -> dict:
    """{net: {name: tensor}} for `shapes` = {net: [(name, shape, kind)]}."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for net, leaves in shapes.items():
        drawn = [(n, s, k) for n, s, k in leaves if k in ("dense", "small")]
        z = torch.randn(sum(math.prod(s) for _, s, _ in drawn), generator=g,
                        device=device)
        w, i = {}, 0
        for name, shape, kind in drawn:
            n = math.prod(shape)
            scale = (SMALL_HEAD if kind == "small"
                     else 1.0 / math.sqrt(shape[1]))
            w[name] = (z[i:i + n] * scale).reshape(shape)
            i += n
        for name, shape, kind in leaves:
            if kind in ("zero", "one"):
                w[name] = (torch.zeros if kind == "zero" else torch.ones)(
                    shape, device=device)
            elif kind not in ("dense", "small"):
                raise ValueError(f"unknown weight kind {kind!r}")
        out[net] = {name: w[name] for name, _, _ in leaves}
    return out
