"""bfloat16 pixel DDPG against the JAX reference on the CPU (the state-obs
agents and the nets: tests/test_torch_bf16.py), and the bfloat16 pixel
CLI."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu_torch import train as ttrain
from test_torch_bf16 import bf16_teacher_forced


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_bf16_pixel_ddpg_train_steps_track_jax_teacher_forced():
    """bf16_teacher_forced for pixel DDPG: VisualActor and VisualCritic at
    bfloat16 on 16 x 16 uint8 frame-diff frames, block sampling from the
    quantized ring (late insert)."""
    bf16_teacher_forced("pixel_ddpg")


def test_bf16_pixel_cli_cpu():
    """`--preset pixels --ddpg.dtype bfloat16` at a small size on the CPU:
    rc 0, finite metrics, the plain learner and rollout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = ttrain.main(["--device", "cpu", "--preset", "pixels",
                          "--ddpg.dtype", "bfloat16", "--num-envs", "16",
                          "--render-size", "16", "--ddpg.hidden", "16", "16",
                          "--ddpg.batch-size", "16",
                          "--ddpg.replay-capacity-per-env", "16",
                          "--total-env-steps", "32", "--log-interval", "1",
                          "--steps-per-dispatch", "1",
                          "--canary-env-steps", "0"])
    assert rc == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert len(lines) == 4
    for x in lines:
        assert all(np.isfinite(v) for v in x.values()), x
        assert x["learner_impl"] == 0.0 and x["rollout_impl"] == 0.0
    assert lines[-1]["critic_loss"] > 0.0
