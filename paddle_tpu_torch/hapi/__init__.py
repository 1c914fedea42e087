"""The high-level API (``paddle_tpu.hapi`` counterpart): ``Model``, the
callbacks and ``summary``. ``dynamic_flops`` and ``hub`` are not ported
yet."""
from . import callbacks
from .model import Model
from .summary import summary

__all__ = ["Model", "callbacks", "summary"]
