"""Networks of the port (flax numerics in torch)."""

from .nets import ActorMLP, CriticMLP, LayerNorm, polyak

__all__ = ["ActorMLP", "CriticMLP", "LayerNorm", "polyak"]
