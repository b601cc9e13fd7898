"""Episode event log: trace, replay, offline debugging.

The port's copy of cartpoleplusplus_tpu/eventlog (writer.py and the
native C++ engine in _native/), so that the port imports nothing of the
JAX package. The files it writes are byte-identical to the reference's.

CLI: `python -m cartpoleplusplus_tpu_torch.eventlog dump <file.cpe>`.
"""

from .writer import (
    EpisodeSink,
    EventLogWriter,
    next_episode_ids,
    read_records,
    validate,
)

__all__ = ["EpisodeSink", "EventLogWriter", "next_episode_ids",
           "read_records", "validate"]
