"""Print options — counterpart of ``paddle_tpu.tensor.to_string``.

The port's tensors are torch's, so ``set_printoptions`` sets torch's
print options (the same names) and remembers them; ``get_printoptions``
reads them back. Defaults are the reference's: precision 8, threshold
1000, edge items 3, no scientific mode, 80 columns.
"""
from __future__ import annotations

import torch

__all__ = ["set_printoptions"]

_PRINT_OPTS = {"precision": 8, "threshold": 1000, "edgeitems": 3,
               "sci_mode": False, "linewidth": 80}


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Set the options given (None leaves one as it is)."""
    for k, v in (("precision", precision), ("threshold", threshold),
                 ("edgeitems", edgeitems), ("sci_mode", sci_mode),
                 ("linewidth", linewidth)):
        if v is not None:
            _PRINT_OPTS[k] = v
    torch.set_printoptions(**_PRINT_OPTS)


def get_printoptions() -> dict:
    return dict(_PRINT_OPTS)
