"""The high-level API (``paddle_tpu.hapi`` counterpart): ``Model``, the
callbacks, ``summary``, ``flops`` (``dynamic_flops``) and ``hub``."""
from . import callbacks, dynamic_flops, hub
from .dynamic_flops import flops
from .model import Model
from .summary import summary

__all__ = ["Model", "callbacks", "summary", "flops", "hub",
           "dynamic_flops"]
