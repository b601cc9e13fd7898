"""cartpoleplusplus_tpu_torch — the PyTorch/CUDA port of cartpoleplusplus_tpu.

The JAX package `cartpoleplusplus_tpu` is the reference; this package
mirrors its module names (physics/, env/, ops/, models/, agents/,
train.py) so each counterpart is easy to find. It imports torch and never
JAX: on a CUDA device the two rollout kernels of the DDPG train path run
as hand-written CUDA (csrc/, built with nvcc at first use), and on the
CPU every kernel wrapper runs its plain torch twin.
"""

__version__ = "0.1.0"

from .env import CartPole3D, EnvState
from .physics import CartPoleParams, continuous_params

__all__ = [
    "CartPole3D",
    "EnvState",
    "CartPoleParams",
    "continuous_params",
    "__version__",
]
