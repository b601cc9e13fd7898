"""Networks of the port (flax numerics in torch)."""

from .nets import ActorMLP, CriticMLP, LayerNorm, PolicyMLP, QNetMLP, polyak

__all__ = ["ActorMLP", "CriticMLP", "LayerNorm", "PolicyMLP", "QNetMLP",
           "polyak"]
