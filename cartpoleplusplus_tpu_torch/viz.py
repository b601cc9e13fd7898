"""Visual inspection CLI: render rollouts to image files
(cartpoleplusplus_tpu/viz.py in torch).

Usage:
    python -m cartpoleplusplus_tpu_torch.viz --steps 60 --out frames/
    python -m cartpoleplusplus_tpu_torch.viz --policy random --width 128
    python -m cartpoleplusplus_tpu_torch.viz --device cpu

Writes one PNG (if matplotlib is available) or binary PPM per env-step,
camera 0 of the pixel-observation RenderConfig. Frames render through
`ops.render_kernel.render_frames`: kernel B10 on a CUDA device, its plain
twin `env/pixels.py::render_all_cameras` on the CPU. `save_frame` is also
what `train --eval-only --eval-render` and `eventlog dump --png` write
with.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .env import CartPole3D
from .env.pixels import CameraConfig, RenderConfig
from .physics import CartPoleParams


def _write_ppm(path: str, img: np.ndarray) -> None:
    """Dependency-free binary PPM (P6) writer. img: (H, W, 3) u8."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def save_frame(path_base: str, img01: np.ndarray) -> str:
    """Save one float [0,1] frame as PNG (matplotlib) or PPM fallback."""
    img = (np.clip(img01, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    try:
        import matplotlib.image as mpimg

        mpimg.imsave(path_base + ".png", img)
        return path_base + ".png"
    except ImportError:
        _write_ppm(path_base + ".ppm", img)
        return path_base + ".ppm"


def main(argv=None) -> int:
    from .ops.render_kernel import render_frames

    ap = argparse.ArgumentParser(prog="cartpoleplusplus_tpu_torch.viz",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--out", default="cartpole_frames")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", choices=["noop", "random"], default="noop")
    ap.add_argument("--env-index", type=int, default=0,
                    help="which env of the small batch to record")
    ap.add_argument("--device", default="cuda",
                    help="cuda | cpu (never falls back)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda but no CUDA device is visible (pass --device "
              "cpu)", file=sys.stderr)
        return 2

    params = CartPoleParams()
    env = CartPole3D(params, num_envs=4, device=device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       cameras=(CameraConfig(),))
    state, _ = env.reset(args.seed)
    g = torch.Generator(device=device).manual_seed(args.seed)

    os.makedirs(args.out, exist_ok=True)
    paths = []
    for t in range(args.steps):
        img = render_frames(params, cfg, state.phys)[args.env_index]
        paths.append(save_frame(os.path.join(args.out, f"step{t:04d}"),
                                img.cpu().numpy()))
        if args.policy == "random":
            action = torch.randint(0, 5, (4,), generator=g, device=device,
                                   dtype=torch.int32)
        else:
            action = torch.zeros((4,), dtype=torch.int32, device=device)
        state, _, _, _, _ = env.step(state, action)
    print(f"wrote {len(paths)} frames to {args.out} "
          f"({os.path.basename(paths[0])} .. {os.path.basename(paths[-1])})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
