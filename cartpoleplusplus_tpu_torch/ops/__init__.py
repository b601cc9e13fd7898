"""Hand-written CUDA kernels and their plain torch twins.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
twin for CPU tensors; `<wrapper>.launches` counts kernel launches.

  B1 fused_rollout.fused_rollout    csrc/fused_rollout.cu   physics-only rollout
  B2 policy_rollout.policy_rollout  csrc/policy_rollout.cu  DDPG actor in the loop
  B3 learner_kernel.ddpg_update_phase  csrc/ddpg_update.cu  K-update DDPG learner
  B4 q_rollout.q_policy_rollout     csrc/q_rollout.cu       DQN Q-net in the loop
  B5 learner_kernel.dqn_update_phase   csrc/dqn_update.cu   K-update DQN learner
  B8 pg_rollout.pg_policy_rollout   csrc/q_rollout.cu       LRPG policy in the loop
  B9 learner_kernel.lrpg_update_phase  csrc/lrpg_update.cu  LRPG update
  B10 render_kernel.render_frames   csrc/render.cu          pixel raycast renderer
  B11 render_kernel.render_culled   csrc/render.cu          ... with row-band culling
"""
