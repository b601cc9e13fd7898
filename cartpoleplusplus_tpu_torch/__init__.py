"""cartpoleplusplus_tpu_torch — the PyTorch/CUDA port of the JAX package
cartpoleplusplus_tpu (the reference).

The JAX package `cartpoleplusplus_tpu` is the reference; this package
mirrors its module names (physics/, env/, ops/, models/, agents/,
train.py) so each counterpart is easy to find. It imports torch and never
JAX: on a CUDA device the rollout and learner kernels of the DDPG, DQN and
LRPG train paths run as hand-written CUDA (csrc/, built with nvcc at first
use), and on the CPU every kernel wrapper runs its plain torch twin.
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
