from .moe import (ExpertMLP, GShardGate, MoELayer, NaiveGate,
                  SwitchGate)

__all__ = ["ExpertMLP", "GShardGate", "MoELayer", "NaiveGate",
           "SwitchGate"]
