from .cartpole import CartPole3D, EnvState, derive_env_seeds
from .obs import FRAME_SIZE, OBS_MODES, obs_size, pose_frame, state_obs

__all__ = [
    "CartPole3D",
    "EnvState",
    "derive_env_seeds",
    "FRAME_SIZE",
    "OBS_MODES",
    "obs_size",
    "pose_frame",
    "state_obs",
]
