"""Event-log inspection CLI (the port's copy of
cartpoleplusplus_tpu/eventlog/__main__.py).

Usage:
    python -m cartpoleplusplus_tpu_torch.eventlog dump <file.cpe> [--frames DIR]
    python -m cartpoleplusplus_tpu_torch.eventlog dump <file.cpe> --frames DIR --png
    python -m cartpoleplusplus_tpu_torch.eventlog validate <file.cpe>
"""

import argparse
import os
import sys

import numpy as np

from .writer import read_records, validate


def _dump(path: str, frames_dir: str | None, png: bool = False):
    """Print per-chunk summaries; optionally dump logged frames as .npy
    slabs or per-step PNG images (PPM where matplotlib is missing). PNG mode
    reshapes the flat frame rows with the `obs_shape` recorded in the
    log's metadata and writes camera 0's RGB channels."""
    n_chunks = 0
    obs_shape = None
    for kind, rec in read_records(path):
        if kind == "metadata":
            print(f"metadata: {rec}")
            if isinstance(rec, dict) and rec.get("obs_shape"):
                obs_shape = tuple(rec["obs_shape"])
            continue
        n_chunks += 1
        r = rec["reward"]
        print(f"episode {rec['episode_id']:6d} env {rec['env_id']:5d} "
              f"steps {len(r):4d} return {r.sum():8.2f} "
              f"done {bool(rec['done'][-1])}")
        if frames_dir and rec["frames"] is not None:
            os.makedirs(frames_dir, exist_ok=True)
            base = f"ep{rec['episode_id']}_env{rec['env_id']}"
            if png:
                if obs_shape is None or len(obs_shape) != 3:
                    sys.exit("--png needs an `obs_shape` metadata record "
                             "(logs written by train.py have one)")
                from ..viz import save_frame
                imgs = rec["frames"].reshape((-1,) + obs_shape)
                for t, img in enumerate(imgs):
                    save_frame(os.path.join(frames_dir, f"{base}_t{t:04d}"),
                               img[..., :3].astype(np.float32) / 255.0)
            else:
                np.save(os.path.join(frames_dir, base + ".npy"),
                        rec["frames"])
    print(f"{n_chunks} chunks")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cartpoleplusplus_tpu_torch.eventlog")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump", help="print episode summaries")
    d.add_argument("path")
    d.add_argument("--frames", default=None,
                   help="directory to dump frame arrays into")
    d.add_argument("--png", action="store_true",
                   help="write per-step PNG images instead of .npy slabs")
    v = sub.add_parser("validate", help="check framing + CRCs")
    v.add_argument("path")
    args = ap.parse_args(argv)
    if args.cmd == "dump":
        _dump(args.path, args.frames, png=args.png)
    else:
        print(f"{validate(args.path)} records OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
