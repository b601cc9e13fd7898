"""The learners B3, B5 and B7 at the suite cadence and at their defaults.

    python experiments/learner_suite_split.py split
    python experiments/learner_suite_split.py times

`split` builds csrc/ddpg_update.cu, csrc/dqn_update.cu and
csrc/naf_update.cu with -DCP_STAGE_CLOCK (chip_smoke.py's stage-clock
builds) and splits one launch of each at batch 8192 x K 8, hidden (256,
256), obs 42: per grid-synced stage of an update its work and its barrier,
and the items' own phase marks (B3 at "updated", B5 with double DQN, B7
with its clip at 10). `times` times each learner through the package's own
library (CUDA events, mean of 5 launches after a warm-up) at batch 8192 x
K 8 and at its defaults (B3 256 x K 16, B5 and B7 256 x K 8). Run either
on a machine with the card, from the root of a checkout; to compare two
checkouts, run `times` in each in turns. Prints one JSON line last.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

BATCH, K = 8192, 8
HIDDEN = (256, 256)


def _runs(dev, batch: int, k3: int, k: int) -> dict:
    """Launches of B3, B5 and B7 at `batch` (K k3 for B3, k for the
    others), their inputs from fixed seeds."""
    from cartpoleplusplus_tpu_torch.agents.common import lr_schedule
    from cartpoleplusplus_tpu_torch.agents.naf import NAFConfig
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    g3, b3 = cs._b3_inputs(dev, HIDDEN, batch, k3, seed=21)
    g5, b5 = cs._b5_inputs(dev, HIDDEN, batch, k, seed=21)
    g7, b7 = cs._b7_inputs(dev, HIDDEN, batch, k, seed=33)
    cfg = NAFConfig()
    return {
        "B3": lambda: lk.ddpg_update_phase(
            g3, b3, cs.B3_T0, HIDDEN, actor_lr=1e-4, critic_lr=1e-3,
            gamma=0.99, tau=0.01),
        "B5": lambda: lk.dqn_update_phase(g5, b5, cs.B3_T0, HIDDEN, lr=5e-5,
                                          gamma=0.99, tau=0.01),
        "B7": lambda: lk.naf_update_phase(
            g7, b7, cs.B3_T0, HIDDEN, lr=cfg.lr, gamma=cfg.gamma,
            tau=cfg.tau, max_grad_norm=cfg.max_grad_norm,
            lr_schedule=lr_schedule(cfg)),
    }


def main() -> int:
    import torch

    from cartpoleplusplus_tpu_torch.ops import _native

    what = sys.argv[1] if len(sys.argv) > 1 else "split"
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"card": cs._card()}
    if what == "split":
        src = {k: os.path.join(_native.CSRC, f)
               for k, f in (("B3", "ddpg_update.cu"), ("B5", "dqn_update.cu"),
                            ("B7", "naf_update.cu"))}
        builds = {k: cs._stage_clock_build(v, k) for k, v in src.items()}
        _native.load_library()
        libs = {k: cs._stage_clock_load(*v) for k, v in builds.items()}
        runs = _runs(dev, BATCH, K, K)
        cs._warm_card(dev, 2.0)
        out["split"] = {
            tag: cs._stage_split(libs[tag], runs[tag], K, tag, phases=ph)
            for tag, ph in (("B3", cs.B3_PHASES), ("B5", cs.B5_PHASES),
                            ("B7", cs.B7_PHASES))}
    else:
        _native.load_library()
        cs._warm_card(dev, 2.0)
        out["ms"] = {}
        for batch, k3, k in ((BATCH, K, K), (256, 16, 8)):
            for tag, run in _runs(dev, batch, k3, k).items():
                out["ms"][f"{tag} {batch}"] = cs._time_ms(run, 5 if batch
                                                          == BATCH else 20)
    out["card_after"] = cs._card()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
