"""The program's own host spans (cartpoleplusplus_tpu_torch/utils/spans.py):
while a profiler records, each `cp.*` span adds its host seconds and one
count to `span.seconds` and `span.counts` under its name. A run's
profiler records the traced window alone, so those totals are the
window's. A program without the spans gives nothing to read."""

from __future__ import annotations


def totals():
    """(seconds, counts) by span name, or None where the program keeps no
    spans."""
    try:
        from cartpoleplusplus_tpu_torch.utils.spans import span
    except ImportError:
        return None
    return span.seconds, span.counts


def ms_per_step(ctx, prefix: str):
    """Host milliseconds per train step of the traced window in the
    program's spans whose names start with `prefix`, summed; None without
    a traced window or such a span. Notes every span's milliseconds and
    count per step."""
    found = totals() if ctx.trace is not None and ctx.steps else None
    if found is None:
        return None
    seconds, counts = found
    ctx.notes["span_ms_per_step"] = {
        n: seconds[n] * 1e3 / ctx.steps for n in sorted(counts)}
    ctx.notes["spans_per_step"] = {
        n: counts[n] / ctx.steps for n in sorted(counts)}
    names = [n for n in counts if n.startswith(prefix)]
    if not names:
        return None
    return sum(seconds[n] for n in names) * 1e3 / ctx.steps
