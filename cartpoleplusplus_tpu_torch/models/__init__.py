"""Networks of the port (flax numerics in torch)."""

from .nets import ActorMLP, CriticMLP, LayerNorm, QNetMLP, polyak

__all__ = ["ActorMLP", "CriticMLP", "LayerNorm", "QNetMLP", "polyak"]
