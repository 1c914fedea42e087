"""Framework helpers (``paddle_tpu.framework`` counterpart): ``save`` and
``load`` with their durability helpers (``io``)."""
from . import io
from .io import load, save

__all__ = ["io", "save", "load"]
