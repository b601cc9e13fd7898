"""Host spans and wait counters at the boundaries of the port's layers.

`span(name, args)` is torch.profiler's `record_function(name, args)` while
a profiler records (`torch.profiler.profile`, as `train.py --profile-dir`
starts it), so the spans are host events on the clock of the device events
in the same trace; otherwise it is one shared null context, and a span
costs the check alone (0.4 us on a CPU core, against 11 us for an
unguarded `record_function`). There is no other switch. While a profiler
records, each span also adds its host seconds and one count to
`span.seconds` and `span.counts` under its name.

The spans, all named `cp.`:

  cp.train_step        an agent's train_step (args: the env_steps it
                       reports)
  cp.rollout           its rollout, kernel or plain
  cp.replay.insert     the replay ring's insert
  cp.replay.presample  the minibatches' draws, index copy and gathers
  cp.learner           the update phase, kernel or plain (and its
                       presample)
  cp.prep.<Bn>         a kernel's wrapper from its entry up to the launch:
                       checks, weight packing, allocations, the launch
                       structures (a learner's span holds its checks on
                       CPU tensors too, before the twin)
  cp.wait.<site>       a place where the host hands data to or takes it
                       from the device: `indices` (the presample's index
                       copy, staged through page-locked memory and queued
                       on the stream, so it does not block), `log` and
                       `eventlog` (train.py's metric and trajectory
                       fetches, which block until the device has drained
                       its queue)

`wait(site)` counts every crossing of a site in `wait.counts`, profiler
or not.
"""

from __future__ import annotations

import collections
import contextlib
import time

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

NULL = contextlib.nullcontext()


class _Timed(record_function):
    """A record_function that adds its host seconds to `span.seconds`."""

    def __enter__(self):
        super().__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        span.seconds[self.name] += time.perf_counter() - self._t0
        span.counts[self.name] += 1
        return super().__exit__(*exc)


def span(name: str, args: str | None = None):
    """The host span `name` while a profiler records, else NULL."""
    return _Timed(name, args) if _profiler_enabled() else NULL


span.seconds = collections.Counter()
span.counts = collections.Counter()


def wait(site: str):
    """The span `cp.wait.<site>` around a transfer between host and
    device; counts the crossing."""
    wait.counts[site] += 1
    return span("cp.wait." + site)


wait.counts = collections.Counter()
