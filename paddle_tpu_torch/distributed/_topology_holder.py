"""The process-global ``HybridCommunicateGroup`` (set by ``fleet.init``)."""
from __future__ import annotations

__all__ = ["current_hcg"]


def current_hcg():
    from .fleet.fleet_base import fleet

    return fleet._hcg
