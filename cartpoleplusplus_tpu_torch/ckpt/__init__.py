"""Checkpoint / resume (cartpoleplusplus_tpu/ckpt in torch): `torch.save`
of the whole agent state (networks, optimizer moments, targets, the
replay ring, env state and the replay-sampling generator) in the
reference's canonical field set, so that a resumed run continues bit for
bit and a checkpoint of either learner layout restores into the other.
"""

from .checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint"]
