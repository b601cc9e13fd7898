"""Networks of the port (flax numerics in torch)."""

from .nets import (ActorMLP, CriticMLP, LayerNorm, NafNet, PatchEncoder,
                   PixelEncoder, PolicyMLP, QNetMLP, VisualActor,
                   VisualCritic, VisualNafNet, VisualPolicy, VisualQNet,
                   polyak)

__all__ = ["ActorMLP", "CriticMLP", "LayerNorm", "NafNet", "PatchEncoder",
           "PixelEncoder", "PolicyMLP", "QNetMLP", "VisualActor",
           "VisualCritic", "VisualNafNet", "VisualPolicy", "VisualQNet",
           "polyak"]
