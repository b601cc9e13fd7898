"""Host milliseconds per train step in the program's `cp.replay.presample`
span: the replay's draws on the CPU generator, the index copy to the card
(and the wait for its queue to drain) and the minibatches' gathers,
timed by the program while the traced window's profiler records. Moves
env_steps_per_s."""

from port_bench.program_spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "cp.replay.presample")
