"""Host milliseconds per train step in the program's `cp.prep.*` spans:
each kernel wrapper from its entry up to the launch (checks, weight
packing, allocations, the launch structures), summed over the step's
kernels, timed by the program while the traced window's profiler
records. Moves env_steps_per_s."""

from port_bench.program_spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "cp.prep.")
