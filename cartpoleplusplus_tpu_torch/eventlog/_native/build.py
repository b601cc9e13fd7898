"""Build + load the native event-log engine (ctypes, no pybind11).

A copy of cartpoleplusplus_tpu/eventlog/_native/build.py. Compiles
eventlog.cpp to libeventlog.so on first use (cached next to the source;
rebuilt when the source is newer). The library is written under a
temporary name and renamed into place, so processes that build it at the
same time never load a half-written file. Falls back to None when no C++
toolchain is available: writer.py then uses its byte-identical
pure-Python path (`EventLogWriter.backend` says which ran).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "eventlog.cpp")
_LIB = os.path.join(_DIR, "libeventlog.so")

_lib = None
_tried = False


def _compile() -> bool:
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    for cc in ("c++", "g++", "clang++"):
        try:
            subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", _SRC, "-o", tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB)
            return True
        except (OSError, subprocess.SubprocessError):
            continue
    if os.path.exists(tmp):
        os.remove(tmp)
    return False


def load():
    """ctypes handle to the native engine, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    fresh = (os.path.exists(_LIB)
             and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC))
    if not fresh and not _compile():
        return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        return None
    lib.eventlog_open.restype = ctypes.c_void_p
    lib.eventlog_open.argtypes = [ctypes.c_char_p]
    lib.eventlog_write_metadata.restype = ctypes.c_int
    lib.eventlog_write_metadata.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.eventlog_write_chunk.restype = ctypes.c_int
    lib.eventlog_write_chunk.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.eventlog_close.restype = ctypes.c_int
    lib.eventlog_close.argtypes = [ctypes.c_void_p]
    lib.eventlog_validate.restype = ctypes.c_int64
    lib.eventlog_validate.argtypes = [ctypes.c_char_p]
    lib.eventlog_open_append.restype = ctypes.c_void_p
    lib.eventlog_open_append.argtypes = [ctypes.c_char_p]
    lib.eventlog_episode_index.restype = ctypes.c_int64
    lib.eventlog_episode_index.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint32]
    lib.eventlog_write_rollout.restype = ctypes.c_int64
    lib.eventlog_write_rollout.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    _lib = lib
    return _lib
