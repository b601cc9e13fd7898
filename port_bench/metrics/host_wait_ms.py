"""Host milliseconds per train step in the program's `cp.wait.*` spans:
where the host blocks until the card has drained its queue (the
presample's index copy), timed by the program while the traced window's
profiler records. Moves env_steps_per_s."""

from port_bench.program_spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "cp.wait.")
