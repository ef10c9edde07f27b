"""flax-style child names for the port's modules.

flax's compact modules name each submodule ``<Class>_<n>``, counting per
class in creation order. The port's modules register their children under
the same names (``Dense_0``, ``SharedMLP_1``, ...), so a reference
variable path maps onto a port parameter path leaf by leaf (convert.py).
"""
from __future__ import annotations

from torch import nn


class FlaxNamed(nn.Module):
    """``nn.Module`` whose ``child`` registers submodules as flax names them."""

    def __init__(self):
        super().__init__()
        self._name_counts = {}

    def child(self, kind: str, module: nn.Module, alias: str | None = None):
        """Register ``module`` as ``<kind>_<n>``. ``alias`` adds a plain
        attribute for readable forward code; it is not a second
        registration, so the state dict holds each tensor once."""
        n = self._name_counts.get(kind, 0)
        self._name_counts[kind] = n + 1
        self.add_module(f"{kind}_{n}", module)
        if alias is not None:
            self.__dict__[alias] = module
        return module
