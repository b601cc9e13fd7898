"""B7, NAF's K-update learner (`naf_update_kernel`, csrc/naf_update.cu on
the row chains of csrc/row_chain.cuh), at two hidden layers: the matrix
products of one update, the 4 group buffers (net, target, Adam moments)
read and written once, the K minibatches read once and one loss per
update written."""

KERNEL = "naf_update_kernel"
HEAD = 6
ACT = 2


def update_flop(obs_dim: int, hidden, batch: int) -> int:
    """The target's torso and V row on s', the online torso and 6-row head
    on s, the head's and layer 1's input gradients, and every weight
    gradient."""
    h0, h1 = hidden
    torso = obs_dim * h0 + h0 * h1
    macs = ((torso + h1) + (torso + HEAD * h1) + (HEAD * h1 + h1 * h0)
            + (torso + HEAD * h1))
    return 2 * batch * macs


def counts(cell) -> tuple:
    s, f = cell.settings, cell.config["obs_dim"]
    k, b = s["updates_per_step"], s["batch_size"]
    h0, h1 = s["hidden"]
    net = f * h0 + h0 + h0 * h1 + h1 + 2 * (h0 + h1) + HEAD * h1 + HEAD
    rows = k * b * (4 * f + 4 * ACT + 4 + 4 * f + 1)
    return (k * update_flop(f, s["hidden"], b),
            2 * 4 * 4 * net + rows + 4 * k)


def net_flop(cell) -> int:
    s = cell.settings
    return s["updates_per_step"] * update_flop(
        cell.config["obs_dim"], s["hidden"], s["batch_size"])
