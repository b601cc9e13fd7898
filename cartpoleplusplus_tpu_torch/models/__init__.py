"""Networks of the port (flax numerics in torch)."""

from .nets import (ActorMLP, CriticMLP, LayerNorm, NafNet, PolicyMLP,
                   QNetMLP, polyak)

__all__ = ["ActorMLP", "CriticMLP", "LayerNorm", "NafNet", "PolicyMLP",
           "QNetMLP", "polyak"]
