"""B6's share of its roofline in the traced window: its bound
(roofline/b6.py's operations at 67 TFLOP/s or bytes at 3.35 TB/s, the
larger) over its mean device time per launch. Moves env_steps_per_s."""

from port_bench.roofline import share


def read(ctx):
    return share(ctx, "b6")
