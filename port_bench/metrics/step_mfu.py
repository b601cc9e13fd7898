"""The whole step's share of the card's float32 peak: the network FLOPs of
the traced window's train steps (each kernel's `net_flop`: the rollout
net's forwards and the learner's forwards, backwards and weight gradients;
not the env math, not Adam) over the window's seconds x 67 TFLOP/s, the
float32 rate the cells' products run at. Moves env_steps_per_s."""

from port_bench.roofline import kernel
from port_bench.roofline.peaks import F32_FLOPS


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    flop = sum(kernel(k).net_flop(ctx.cell)
               for k in ctx.cell.config["kernels"])
    return 100.0 * flop * ctx.steps / (ctx.trace.window_s * F32_FLOPS)
