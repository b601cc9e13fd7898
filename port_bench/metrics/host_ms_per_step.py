"""The host's own milliseconds per train step: after the traced window,
train steps each started on an idle card, the host clock around the call
alone, averaged over calls that add up to 0.3 s. The pace the host sets
when the card is fast; moves env_steps_per_s."""


def read(ctx):
    return ctx.host_ms_per_step
