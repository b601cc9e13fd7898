"""DDPG through the train CLI from initial weights drawn elsewhere.

torch's truncated-normal init changed between releases (by the inverse
CDF, later by rejection), so one `--seed` gives different initial weights
on two installs. This tool separates the weights' draw from the device
and the rest of the run:

    # on one machine: each seed's initial actor and critic, as this torch
    # draws them on the CPU (DDPG.init)
    python -m cartpoleplusplus_tpu_torch.ddpg_init_swap make OUT.pt 0 1 2
    # on another: the train CLI once per seed, each run starting from
    # OUT.pt's weights for its seed (targets equal to them, as at init)
    python -m cartpoleplusplus_tpu_torch.ddpg_init_swap train OUT.pt 0 1 2 \\
        -- --num-envs 1024 --total-env-steps 40000 --final-eval

Everything else (env resets, replay draws, noise, the learner) is the
CLI's own for that seed. `train` prints one line per seed after the
CLI's lines.
"""

from __future__ import annotations

import sys
import time

import torch

from . import train
from .agents import DDPG, DDPGConfig
from .env.cartpole import CartPole3D
from .physics.params import continuous_params


def _weights(st) -> dict:
    return {name: {k: v.detach().cpu().clone()
                   for k, v in net.state_dict().items()}
            for name, net in (("actor", st.actor), ("critic", st.critic))}


def make(path: str, seeds: list) -> None:
    # The env only shapes the agent; the weights come from CPU generators.
    agent = DDPG(CartPole3D(continuous_params(), num_envs=1, device="cpu"),
                 DDPGConfig())
    torch.save({s: _weights(agent.init(s)) for s in seeds}, path)


def run(path: str, seeds: list, cli: list) -> int:
    inits = torch.load(path, weights_only=True)
    own_init = DDPG.init

    def init(self, seed):
        st = own_init(self, seed)
        w = inits[seed]
        with torch.no_grad():
            for net, key in ((st.actor, "actor"), (st.actor_target, "actor"),
                             (st.critic, "critic"),
                             (st.critic_target, "critic")):
                for k, v in net.state_dict().items():
                    v.copy_(w[key][k])
        return st

    DDPG.init = init
    try:
        for seed in seeds:
            t0 = time.perf_counter()
            rc = train.main([*cli, "--seed", str(seed)])
            print(f"ddpg_init_swap: seed {seed} from {path}: rc {rc}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            if rc:
                return rc
    finally:
        DDPG.init = own_init
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cli = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    if len(argv) < 3 or argv[0] not in ("make", "train"):
        print(__doc__, file=sys.stderr)
        return 2
    path, seeds = argv[1], [int(s) for s in argv[2:]]
    if argv[0] == "make":
        make(path, seeds)
        return 0
    return run(path, seeds, cli)


if __name__ == "__main__":
    sys.exit(main())
