"""B3, DDPG's K-update learner (`ddpg_update_kernel`, csrc/ddpg_update.cu
on the row chains of csrc/row_chain.cuh), at two hidden layers: the matrix
products of one update, the 8 group buffers (nets, targets, Adam moments)
read and written once, the K minibatches read once and the two losses per
update written."""

KERNEL = "ddpg_update_kernel"
ACT = 2


def update_flop(obs_dim: int, hidden, batch: int) -> int:
    """The target actor and critic, the critic's forward, backward to layer
    0 and weight gradients, then the actor's and the critic's forward,
    dQ/da, and the actor's backward and weight gradients."""
    h0, h1 = hidden
    actor = obs_dim * h0 + h0 * h1 + ACT * h1
    critic = obs_dim * h0 + (h0 + ACT) * h1 + h1
    macs = (actor + critic
            + critic + (h1 + h0 * h1) + critic
            + actor + critic + (h1 + ACT * h1)
            + (ACT * h1 + h0 * h1) + actor)
    return 2 * batch * macs


def _group_floats(obs_dim: int, hidden) -> int:
    h0, h1 = hidden
    actor = (obs_dim * h0 + h0 + h0 * h1 + h1 + 2 * (h0 + h1)
             + ACT * h1 + ACT)
    critic = (obs_dim * h0 + h0 + (h0 + ACT) * h1 + h1 + 2 * (h0 + h1)
              + h1 + 1)
    return 4 * (actor + critic)


def counts(cell) -> tuple:
    s, f = cell.settings, cell.config["obs_dim"]
    k, b = s["updates_per_step"], s["batch_size"]
    flop = k * update_flop(f, s["hidden"], b)
    rows = k * b * (4 * f + 4 * ACT + 4 + 4 * f + 1)
    return flop, 2 * 4 * _group_floats(f, s["hidden"]) + rows + 8 * k


def net_flop(cell) -> int:
    s = cell.settings
    return s["updates_per_step"] * update_flop(
        cell.config["obs_dim"], s["hidden"], s["batch_size"])
