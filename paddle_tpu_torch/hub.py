"""``paddle_tpu_torch.hub`` — ``list``, ``help`` and ``load`` of
``hapi.hub``."""
from .hapi.hub import help, list, load  # noqa: F401

__all__ = ["list", "help", "load"]
