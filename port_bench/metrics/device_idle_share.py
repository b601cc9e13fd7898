"""The share of the traced window in which the card ran no kernel, copy or
set: 100 x (1 - busy / window), busy the union of the device's intervals
in torch.profiler's trace. Moves env_steps_per_s."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
