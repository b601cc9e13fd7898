"""The numbers that decide `correct`: the program's first three train
steps (or as many as reach the first that learns) against the
reference's, from the same seed and initial weights.

- loss_gap: the widest relative gap of the first learning step's mean
  losses (each loss the configuration names).
- grad_gap: Adam's first moment after the first learning step, the
  gradients as the optimizer got them: per net, the worst leaf's gap
  between the program's norm and the reference's, over the larger of that
  leaf's reference norm and the net's median leaf's.
- change_gap: the same measure of each leaf's change from the initial
  weights after the last compared step, per net the median leaf's. Leaves
  whose reference gradient (that first moment) is under a thousandth of
  the median leaf's move by round-off alone under Adam and are left out.
- change_gap_worst: the same measure by the worst leaf; a reading beside
  the median leaf's, not compared (PERF.md, §6, PR 21).

The first step's loss and the median leaf's change stand where the worst
of every step would swing from seed to seed: after the first learning
step the program's rollouts part from the reference's in a few envs, and
Adam's first updates turn gradient elements that are zero to rounding into
full steps either way (PERF.md, §6, PR 21).
"""

from __future__ import annotations

import dataclasses
import statistics

import torch

NEGLIGIBLE_GRAD = 1e-3


@dataclasses.dataclass
class Readings:
    """What one side gave: the first learning step's losses, the first
    moments after it and the weights after the last compared step."""

    losses: dict
    moments: dict
    weights: dict


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def _leaf_gaps(got: dict, want: dict, keep) -> list:
    ref = {k: _norm(want[k]) for k in keep}
    med = statistics.median(ref.values())
    if med == 0.0:
        return [0.0 if _norm(got[k]) == 0.0 else float("inf") for k in keep]
    gaps = [abs(_norm(got[k]) - ref[k]) / max(ref[k], med) for k in keep]
    return [g if g == g else float("inf") for g in gaps]


def numbers(prog: Readings, ref: Readings, init: dict) -> dict:
    """{name: value} of the numbers above for one run."""
    loss_gap = 0.0
    for key, want in ref.losses.items():
        gap = (abs(prog.losses[key] - want) / abs(want) if want
               else abs(prog.losses[key]))
        loss_gap = max(loss_gap, gap if gap == gap else float("inf"))
    grad_gap = change_gap = change_worst = 0.0
    for net, want in ref.moments.items():
        grad_gap = max(grad_gap, max(_leaf_gaps(prog.moments[net], want,
                                                list(want))))
        norms = {k: _norm(v) for k, v in want.items()}
        floor = NEGLIGIBLE_GRAD * statistics.median(norms.values())
        keep = [k for k, n in norms.items() if n >= floor]
        delta = {k: prog.weights[net][k] - init[net][k] for k in keep}
        ref_delta = {k: ref.weights[net][k] - init[net][k] for k in keep}
        gaps = _leaf_gaps(delta, ref_delta, keep)
        change_gap = max(change_gap, statistics.median(gaps))
        change_worst = max(change_worst, max(gaps))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "change_gap_worst": change_worst}
