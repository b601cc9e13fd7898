"""Seconds this process spent on the kernels' library: the staleness check
and the build (`load_library.build_s`, nvcc on a checkout's first run)
plus the load (`load_library.load_s`), the program's own counters; both
parts and the builds go to the notes. None where the program keeps no
such counters or loaded no library. Moves setup_s."""


def read(ctx):
    try:
        from cartpoleplusplus_tpu_torch.ops._native import load_library
    except ImportError:
        return None
    if not getattr(load_library, "load_s", 0.0):
        return None
    ctx.notes["library_build_s"] = load_library.build_s
    ctx.notes["library_load_s"] = load_library.load_s
    ctx.notes["library_builds"] = load_library.builds
    return load_library.build_s + load_library.load_s
