"""Event-log writer/reader: trace, replay and offline debugging.

A copy of cartpoleplusplus_tpu/eventlog/writer.py (pure Python and numpy;
the port imports nothing of the JAX package). Format:
cartpoleplusplus_tpu/eventlog/format.md, column-major episode chunks,
CRC-framed. The train loop never touches this: the `EpisodeSink` consumes
already-fetched host arrays (one window of rollout chunks per dispatch)
and splits them into per-env episode segments. Serialization goes through
the native C++ engine when a compiler is at hand (_native/build.py) or a
byte-identical pure-Python path; `EventLogWriter.backend` says which.
tests/test_torch_eventlog.py holds the bytes equal to the reference's.
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
import zlib

import numpy as np

from ._native.build import load as _load_native

MAGIC = 0x45505043
VERSION = 1
KIND_EPISODE = 1
KIND_METADATA = 2


class EventLogWriter:
    """Writes .cpe files; native C++ engine when available."""

    def __init__(self, path: str, metadata: dict | None = None,
                 use_native: bool | None = None, append: bool = False):
        """append=True continues an existing log (resume) instead of
        truncating it; the header is only written for a fresh file.
        Both modes go through the native C++ engine when available
        (eventlog_open / eventlog_open_append); the Python fallback is
        byte-identical."""
        self.path = path
        appending = append and os.path.exists(path) and \
            os.path.getsize(path) >= 8
        native = _load_native() if use_native in (None, True) else None
        if use_native is True and native is None:
            raise RuntimeError("native event-log engine unavailable")
        self._native = native
        if native is not None:
            self._handle = (native.eventlog_open_append(path.encode())
                            if appending
                            else native.eventlog_open(path.encode()))
            if not self._handle:
                raise OSError(f"cannot open {path}")
            self._file = None
        else:
            self._handle = None
            self._file = open(path, "ab" if appending else "wb")
            if not appending:
                self._file.write(struct.pack("<II", MAGIC, VERSION))
        if metadata is not None:
            self.write_metadata(metadata)

    @property
    def backend(self) -> str:
        return "native" if self._native is not None else "python"

    def _write_record_py(self, kind: int, payload: bytes):
        self._file.write(struct.pack("<IQ", kind, len(payload)))
        self._file.write(payload)
        self._file.write(struct.pack("<I", zlib.crc32(payload)))

    def write_metadata(self, metadata: dict):
        blob = json.dumps(metadata, sort_keys=True).encode()
        if self._native is not None:
            rc = self._native.eventlog_write_metadata(
                self._handle, blob, len(blob))
            if rc != 0:
                raise OSError("metadata write failed")
        else:
            self._write_record_py(
                KIND_METADATA, struct.pack("<I", len(blob)) + blob)

    def write_chunk(self, episode_id: int, env_id: int, state, action,
                    reward, done, frames=None):
        """One contiguous segment of one env's episode.

        state (T, D) f32; action (T, A) f32 (discrete: (T, 1));
        reward (T,) f32; done (T,) bool/u8; frames optional (T, F) u8.
        """
        state = np.ascontiguousarray(state, np.float32)
        if state.ndim > 2:  # e.g. (T, H, W, C) pixel obs -> flat rows
            state = state.reshape(state.shape[0], -1)
        action = np.ascontiguousarray(action, np.float32)
        if action.ndim == 1:
            action = action[:, None]
        reward = np.ascontiguousarray(reward, np.float32)
        done = np.ascontiguousarray(done, np.uint8)
        t, d = state.shape
        a = action.shape[1]
        if frames is not None:
            frames = np.ascontiguousarray(frames, np.uint8).reshape(t, -1)
            f = frames.shape[1]
        else:
            f = 0
        if self._native is not None:
            rc = self._native.eventlog_write_chunk(
                self._handle, episode_id, env_id, t, d, a, f,
                state.ctypes.data_as(ctypes.c_void_p),
                action.ctypes.data_as(ctypes.c_void_p),
                reward.ctypes.data_as(ctypes.c_void_p),
                done.ctypes.data_as(ctypes.c_void_p),
                frames.ctypes.data_as(ctypes.c_void_p) if f else None)
            if rc != 0:
                raise OSError("chunk write failed")
        else:
            payload = (struct.pack("<QIIIII", episode_id, env_id, t, d, a, f)
                       + state.tobytes() + action.tobytes()
                       + reward.tobytes() + done.tobytes()
                       + (frames.tobytes() if f else b""))
            self._write_record_py(KIND_EPISODE, payload)

    def close(self):
        if self._native is not None:
            if self._handle:
                self._native.eventlog_close(self._handle)
                self._handle = None
        elif self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def validate(path: str) -> int:
    """Record count after full framing+CRC validation (native engine when
    available). Raises on corruption."""
    native = _load_native()
    if native is not None:
        n = native.eventlog_validate(path.encode())
        if n < 0:
            raise ValueError(f"corrupt or unreadable event log: {path}")
        return int(n)
    return sum(1 for _ in read_records(path))


def read_records(path: str):
    """Yield ('metadata', dict) and ('chunk', dict-of-arrays) records."""
    with open(path, "rb") as fh:
        magic, version = struct.unpack("<II", fh.read(8))
        if magic != MAGIC or version != VERSION:
            raise ValueError(f"not a .cpe event log: {path}")
        while True:
            head = fh.read(12)
            if not head:
                return
            kind, ln = struct.unpack("<IQ", head)
            payload = fh.read(ln)
            (crc,) = struct.unpack("<I", fh.read(4))
            if len(payload) != ln or crc != zlib.crc32(payload):
                raise ValueError(f"corrupt record in {path}")
            if kind == KIND_METADATA:
                (jlen,) = struct.unpack_from("<I", payload)
                yield "metadata", json.loads(payload[4:4 + jlen])
            elif kind == KIND_EPISODE:
                eid, env, t, d, a, f = struct.unpack_from("<QIIIII", payload)
                off = 28
                state = np.frombuffer(payload, np.float32, t * d, off
                                      ).reshape(t, d)
                off += 4 * t * d
                action = np.frombuffer(payload, np.float32, t * a, off
                                       ).reshape(t, a)
                off += 4 * t * a
                reward = np.frombuffer(payload, np.float32, t, off)
                off += 4 * t
                done = np.frombuffer(payload, np.uint8, t, off).astype(bool)
                off += t
                frames = (np.frombuffer(payload, np.uint8, t * f, off
                                        ).reshape(t, f) if f else None)
                yield "chunk", {
                    "episode_id": eid, "env_id": env, "state": state,
                    "action": action, "reward": reward, "done": done,
                    "frames": frames,
                }
            else:
                raise ValueError(f"unknown record kind {kind}")


def next_episode_ids(path: str, num_envs: int) -> np.ndarray:
    """Per-env first-unused episode id in an existing log: max seen + 1
    (a resumed run resets env state, so the trailing in-progress episode
    is abandoned rather than continued — its id must not be reused for
    unrelated new steps). Uses the native header-walking index when
    available (O(records), fseek past array payloads); Python decode
    fallback otherwise."""
    ids = np.full(num_envs, -1, np.int64)
    native = _load_native()
    if native is not None:
        n = native.eventlog_episode_index(
            path.encode(), ids.ctypes.data_as(ctypes.c_void_p),
            np.uint32(num_envs))
        if n >= 0:
            return ids + 1
        ids[:] = -1  # corrupt header walk: fall through to full decode
    for kind, rec in read_records(path):
        if kind == "chunk" and rec["env_id"] < num_envs:
            ids[rec["env_id"]] = max(ids[rec["env_id"]],
                                     int(rec["episode_id"]))
    return ids + 1


class EpisodeSink:
    """Splits fetched rollout chunks into per-env episode segments.

    Feed it time-major host arrays from each train/rollout step
    ((T, B, D) state, (T, B, ...) action, (T, B) reward/done); it writes
    one chunk record per (env, contiguous segment), tracking episode ids
    across calls. This is the host-side sibling of the device rollout —
    the reference's per-step `event_log.add(...)` hook becomes one bulk
    call per fused step.
    """

    def __init__(self, writer: EventLogWriter, num_envs: int,
                 obs_as_frames: bool = False, initial_episode_ids=None):
        """obs_as_frames=True stores [0,1]-float image observations in the
        uint8 `frames` field (4x smaller than f32 state; the reference
        likewise logged rendered frames separately from poses).
        initial_episode_ids seeds the per-env episode counters — pass
        `next_episode_ids(path, num_envs)` when appending to an existing
        log so resumed runs never reuse an (env_id, episode_id) pair."""
        self.writer = writer
        self.obs_as_frames = obs_as_frames
        self.episode_ids = (np.zeros(num_envs, np.int64)
                            if initial_episode_ids is None
                            else np.asarray(initial_episode_ids, np.int64)
                            .copy())

    def add_rollout(self, state, action, reward, done, frames=None):
        state = np.asarray(state)
        action = np.asarray(action)
        reward = np.asarray(reward)
        done = np.asarray(done, bool)
        t, b = reward.shape
        if self.obs_as_frames and frames is None:
            frames = (state if state.dtype == np.uint8 else
                      np.clip(state * 255.0 + 0.5, 0, 255).astype(np.uint8))
            state = np.zeros((t, b, 0), np.float32)
        # One batch-major transpose up front: per-env segments then slice
        # contiguously (no per-chunk copy in the writer) — ~3x faster than
        # fancy-indexing the time-major arrays per env.
        state = np.ascontiguousarray(np.moveaxis(state, 0, 1))
        action = np.ascontiguousarray(np.moveaxis(action, 0, 1))
        reward_b = np.ascontiguousarray(reward.T)
        done_b = np.ascontiguousarray(done.T)
        if frames is not None:
            frames = np.ascontiguousarray(np.moveaxis(np.asarray(frames),
                                                      0, 1))
        if self.writer._native is not None:
            # The whole segmentation + serialization path in one native
            # call (byte-identical records; episode counters advanced in
            # place).
            state = np.ascontiguousarray(state.reshape(b, t, -1),
                                         np.float32)
            if action.ndim == 2:
                action = action[:, :, None]
            action = np.ascontiguousarray(action.astype(np.float32))
            fr = (np.ascontiguousarray(frames.reshape(b, t, -1))
                  if frames is not None else None)
            done_u8 = np.ascontiguousarray(done_b.astype(np.uint8))
            n = self.writer._native.eventlog_write_rollout(
                self.writer._handle,
                self.episode_ids.ctypes.data_as(ctypes.c_void_p),
                np.uint32(b), np.uint32(t),
                np.uint32(state.shape[2]), np.uint32(action.shape[2]),
                np.uint32(fr.shape[2] if fr is not None else 0),
                state.ctypes.data_as(ctypes.c_void_p),
                action.ctypes.data_as(ctypes.c_void_p),
                reward_b.ctypes.data_as(ctypes.c_void_p),
                done_u8.ctypes.data_as(ctypes.c_void_p),
                fr.ctypes.data_as(ctypes.c_void_p) if fr is not None
                else None)
            if n < 0:
                raise OSError("rollout write failed")
            return
        for env in range(b):
            bounds = np.flatnonzero(done_b[env])
            start = 0
            for end in list(bounds + 1) + ([t] if (not len(bounds) or
                                                   bounds[-1] != t - 1)
                                           else []):
                seg = slice(start, end)
                self.writer.write_chunk(
                    int(self.episode_ids[env]), env, state[env, seg],
                    action[env, seg], reward_b[env, seg], done_b[env, seg],
                    None if frames is None else frames[env, seg])
                if end <= t and done_b[env, end - 1]:
                    self.episode_ids[env] += 1
                start = end
