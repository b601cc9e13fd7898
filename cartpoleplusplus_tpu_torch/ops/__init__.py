"""Hand-written CUDA kernels and their plain torch twins.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
twin for CPU tensors; `<wrapper>.launches` counts kernel launches.

  B1 fused_rollout.fused_rollout    csrc/fused_rollout.cu   physics-only rollout
  B2 policy_rollout.policy_rollout  csrc/policy_rollout.cu  DDPG actor in the loop
"""
