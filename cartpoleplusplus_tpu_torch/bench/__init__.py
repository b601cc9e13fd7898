from .harness import build_rollout, measure_env_steps_per_sec

__all__ = ["build_rollout", "measure_env_steps_per_sec"]
