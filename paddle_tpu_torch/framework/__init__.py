"""Framework helpers (``paddle_tpu.framework`` counterpart): ``save`` and
``load`` with their durability helpers (``io``) and the at-rest cipher
(``io_crypto``)."""
from . import io, io_crypto
from .io import load, save

__all__ = ["io", "io_crypto", "save", "load"]
