"""B5, DQN's K-update learner (`dqn_update_kernel`, csrc/dqn_update.cu on
the row chains of csrc/row_chain.cuh), at two hidden layers: per update
three forwards (the online net on s and s', the target on s'), the backward
to layer 0 and the weight gradients; the 4 group buffers (net, target,
Adam moments) read and written once, the K minibatches read once and one
loss per update written."""

KERNEL = "dqn_update_kernel"
ACTIONS = 5


def update_flop(obs_dim: int, hidden, batch: int) -> int:
    h0, h1 = hidden
    fwd = obs_dim * h0 + h0 * h1 + h1 * ACTIONS
    return 2 * batch * (3 * fwd + (ACTIONS * h1 + h1 * h0) + fwd)


def counts(cell) -> tuple:
    s, f = cell.settings, cell.config["obs_dim"]
    k, b = s["updates_per_step"], s["batch_size"]
    h0, h1 = s["hidden"]
    q = (f * h0 + h0 + h0 * h1 + h1 + 2 * (h0 + h1) + ACTIONS * h1
         + ACTIONS)
    rows = k * b * (4 * f + 4 + 4 + 4 * f + 1)
    return (k * update_flop(f, s["hidden"], b),
            2 * 4 * 4 * q + rows + 4 * k)


def net_flop(cell) -> int:
    s = cell.settings
    return s["updates_per_step"] * update_flop(
        cell.config["obs_dim"], s["hidden"], s["batch_size"])
