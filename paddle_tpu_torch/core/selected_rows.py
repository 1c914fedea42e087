"""Row-sparse gradients — counterpart of ``paddle_tpu.core.selected_rows``.

A ``RowSparseGrad`` is a (rows, values) gradient of a [num_rows, dim]
parameter: ``values[i]`` belongs to row ``rows[i]``, a row may repeat, and
a row outside [0, num_rows) is padding that every use drops (the
reference marks padded lookups with the sentinel row ``num_rows``).

On a parameter the gradient is carried by torch's own sparse COO tensor:
``nn.functional.embedding(..., sparse=True)`` makes one, autograd adds two
of them by concatenating their entries (the reference's sparse + sparse)
and a sparse and a dense one into a dense tensor (sparse + dense
densifies), and it leaves out the lookups of ``padding_idx``. The
optimizers and clips read a COO gradient through ``from_coo`` and work on
the rows. Unlike the reference's, whose shapes are
static for XLA, ``merged()`` has one row per distinct row (padding
dropped), so the row updates gather and scatter exactly the touched rows.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["RowSparseGrad"]


class RowSparseGrad:
    """(rows, values) gradient of a [num_rows, dim...] parameter: ``rows``
    int64 [n] (duplicates allowed; a row outside [0, num_rows) is
    padding), ``values`` [n, dim...]."""

    __slots__ = ("rows", "values", "num_rows", "_merged", "_mcache")

    def __init__(self, rows: torch.Tensor, values: torch.Tensor,
                 num_rows: int, merged: bool = False):
        self.rows = rows.reshape(-1).long()
        self.values = values
        self.num_rows = int(num_rows)
        self._merged = merged
        self._mcache: Optional[RowSparseGrad] = None

    @classmethod
    def from_coo(cls, g: torch.Tensor) -> "RowSparseGrad":
        """The rows of a sparse COO gradient whose first dimension is
        sparse (``embedding``'s), its entries as they are (duplicates
        kept)."""
        if g.sparse_dim() != 1:
            raise ValueError("a row-sparse gradient has one sparse "
                             f"dimension, got {g.sparse_dim()}")
        return cls(g._indices()[0], g._values(), g.shape[0],
                   merged=g.is_coalesced())

    # -- the tensor-like surface ----------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def shape(self):
        return torch.Size((self.num_rows, *self.values.shape[1:]))

    # -- the operations ---------------------------------------------------
    def _valid(self) -> "RowSparseGrad":
        """The entries whose row is in [0, num_rows)."""
        keep = (self.rows >= 0) & (self.rows < self.num_rows)
        if bool(keep.all()):
            return self
        return RowSparseGrad(self.rows[keep], self.values[keep],
                             self.num_rows, self._merged)

    def merged(self) -> "RowSparseGrad":
        """Each distinct row once, in increasing order, with the sum of
        its values (padding rows dropped). Duplicates must be combined
        before a moment update, or its decay applies more than once."""
        if self._merged:
            return self._valid()
        if self._mcache is None:
            v = self._valid()
            rows, inv = torch.unique(v.rows, sorted=True, return_inverse=True)
            vals = torch.zeros((rows.numel(), *v.values.shape[1:]),
                               dtype=v.values.dtype, device=v.values.device)
            vals.index_add_(0, inv, v.values)
            self._mcache = RowSparseGrad(rows, vals, self.num_rows,
                                         merged=True)
        return self._mcache

    def to_dense(self) -> torch.Tensor:
        v = self._valid()
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return out.index_add_(0, v.rows, v.values)

    def __add__(self, other: Union["RowSparseGrad", torch.Tensor, None]):
        if isinstance(other, RowSparseGrad):
            return RowSparseGrad(torch.cat([self.rows, other.rows]),
                                 torch.cat([self.values, other.values]),
                                 self.num_rows)
        if other is None:
            return self
        # sparse + dense densifies (the reference's SelectedRows + dense)
        return self.to_dense() + other

    __radd__ = __add__

    def scale(self, coeff) -> "RowSparseGrad":
        """The values times ``coeff`` (a float or a 0-d tensor)."""
        return RowSparseGrad(self.rows, self.values * coeff, self.num_rows,
                             self._merged)

    def sq_l2norm(self) -> torch.Tensor:
        """Σ values² in f32 over the MERGED rows (duplicates combined
        first, or the norm overcounts; padding rows left out, as their
        positions give 0 on the dense path)."""
        return self.merged().values.float().square().sum()

    def __repr__(self):
        return (f"RowSparseGrad(rows={tuple(self.rows.shape)}, "
                f"values={tuple(self.values.shape)}, "
                f"num_rows={self.num_rows})")
