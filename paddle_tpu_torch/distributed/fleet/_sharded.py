"""The engine's multi-device state: which rows of the batch a rank keeps,
and the flat per-dtype buffers that its parameters, gradients and ZeRO
shards live in.

``BatchSharding`` splits a global batch as the reference's batch
``NamedSharding`` places it: dim 0 over the data axes (``dp_axis`` then
``extra_batch_axes``, row-major), and with ``sp_axis`` dim 1 of every
leaf whose dim 1 divides the ring over the sequence axis. Ranks that
differ only along other axes (``sharding``, a replica axis) keep the same
rows.

``FlatBucket`` holds the parameters of one dtype in one flat buffer, each
parameter at an offset aligned to ``ALIGN`` elements, the total padded to
a multiple of ``ALIGN · s`` (``s`` the sharding group's size). Rank ``c``
of the sharding group owns the contiguous shard ``[c·S, (c+1)·S)`` and,
inside it, a piece of every parameter whose range meets it; the
optimizer's moments (and masters) exist only for the shard, as flat
``[S]`` buffers whose slices are the pieces' state. This is a contiguous
layout: the reference splits the first evenly divisible dimension of each
parameter instead (``param_partition_spec``); the engine's gathered values
are the same either way.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .mesh_utils import PartitionSpec

__all__ = ["BatchSharding", "FlatBucket", "Piece", "ALIGN"]

ALIGN = 64  # elements: every parameter and shard starts 128-byte aligned


def _tree_map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class BatchSharding:
    """The rows (and sequence positions) of a global batch that this rank
    keeps (see the module docstring). ``local(tree)`` slices every leaf;
    the slices it returns are marked as this sharding's, and ``local``
    passes marked leaves through (a prefetched batch is staged once)."""

    def __init__(self, mesh, batch_axes: Sequence[str],
                 sp_axis: Optional[str] = None):
        self.mesh = mesh
        self.batch_axes = tuple(a for a in batch_axes if a is not None)
        self.sp_axis = sp_axis
        coords = mesh.coords()
        self.parts = int(np.prod([mesh.shape[a] for a in self.batch_axes])
                         ) if self.batch_axes else 1
        index = 0
        for a in self.batch_axes:
            index = index * mesh.shape[a] + coords[a]
        self.index = index
        self.sp = mesh.shape[sp_axis] if sp_axis else 1
        self.sp_index = coords[sp_axis] if sp_axis else 0

    @property
    def spec(self) -> PartitionSpec:
        dim0 = (self.batch_axes if len(self.batch_axes) > 1 else
                (self.batch_axes[0] if self.batch_axes else None))
        return (PartitionSpec(dim0, self.sp_axis) if self.sp_axis
                else PartitionSpec(dim0))

    def _leaf(self, x):
        if getattr(x, "_ptt_batch_sharding", None) is self:
            return x
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        if x.dim() == 0:
            return x
        if self.parts > 1:
            n = x.shape[0]
            if n % self.parts:
                raise ValueError(
                    f"a batch leaf of {n} rows does not split over the "
                    f"{self.parts} ranks of the data axes "
                    f"{self.batch_axes}")
            rows = n // self.parts
            x = x.narrow(0, self.index * rows, rows)
        if self.sp > 1 and x.dim() >= 2 and x.shape[1] >= self.sp \
                and x.shape[1] % self.sp == 0:
            cols = x.shape[1] // self.sp
            x = x.narrow(1, self.sp_index * cols, cols)
        return x.contiguous()

    def local(self, tree):
        return _tree_map(self._leaf, tree)

    def mark(self, tree):
        """Mark every tensor leaf of ``tree`` as already local."""
        def _mark(x):
            if isinstance(x, torch.Tensor):
                x._ptt_batch_sharding = self
            return x

        return _tree_map(_mark, tree)


class Piece(NamedTuple):
    """The part of parameter ``index`` (of its bucket) that this rank's
    shard holds: shard elements ``[a, b)``, parameter elements
    ``[a + shard_start - offset, ...)``."""
    index: int
    a: int
    b: int
    p_lo: int


class FlatBucket:
    """The parameters of one dtype in one flat buffer (see the module
    docstring). ``full`` is the whole buffer (``None`` between the steps
    of ZeRO-3); ``shard`` this rank's ``[S]`` part (a view of ``full``
    below ZeRO-3, its own tensor at ZeRO-3)."""

    def __init__(self, names: List[str], params: List[torch.Tensor],
                 shards: int = 1, coord: int = 0, own_shard: bool = False,
                 hold_params: bool = True):
        self.names = names
        self.params = params
        self.dtype = params[0].dtype
        self.device = params[0].device
        self.shards = shards
        self.coord = coord
        offsets, off = [], 0
        for p in params:
            offsets.append(off)
            off += -(-p.numel() // ALIGN) * ALIGN
        self.offsets = offsets
        self.numels = [p.numel() for p in params]
        self.S = -(-off // (ALIGN * shards)) * ALIGN
        self.total = self.S * shards
        self.start = coord * self.S
        self.pieces: List[Piece] = []
        for i, (o, n) in enumerate(zip(offsets, self.numels)):
            lo, hi = max(o, self.start), min(o + n, self.start + self.S)
            if lo < hi:
                self.pieces.append(Piece(i, lo - self.start,
                                         hi - self.start, lo - o))
        self.grad_full: Optional[torch.Tensor] = None
        self.grad_shard: Optional[torch.Tensor] = None
        # the shard's optimizer state, [S] f32 (the engine makes it under
        # ZeRO), and each parameter's beta powers and whether this rank
        # holds its first element
        self.m1 = self.m2 = self.master = None
        self.b1p = self.b2p = self.owner = None
        self.own_shard = own_shard
        if not hold_params:  # a gradient layout only
            self.full = self.shard = None
            return
        full = torch.zeros(self.total, dtype=self.dtype, device=self.device)
        with torch.no_grad():
            for p, o, n in zip(params, offsets, self.numels):
                full[o:o + n].copy_(p.detach().reshape(-1))
        self.full: Optional[torch.Tensor] = full
        self.shard = (full[self.start:self.start + self.S].clone()
                      if own_shard else
                      full[self.start:self.start + self.S])

    # -- ZeRO-3: the full buffer exists only inside a step ---------------------
    def release(self) -> None:
        """Free ``full``'s memory (its views stay, sized but unbacked)."""
        self.full.untyped_storage().resize_(0)

    def materialize(self) -> torch.Tensor:
        """Give ``full`` its memory back (contents unspecified)."""
        st = self.full.untyped_storage()
        need = self.total * self.full.element_size()
        if st.nbytes() != need:
            st.resize_(need)
        return self.full

    # -- views ----------------------------------------------------------------
    def param_view(self, i: int, flat: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """Parameter ``i`` as a view of ``flat`` (default ``full``)."""
        flat = self.full if flat is None else flat
        o, n = self.offsets[i], self.numels[i]
        return flat[o:o + n].view(self.params[i].shape)

    def install(self) -> None:
        """Point every parameter's ``.data`` at its view of ``full``."""
        for i, p in enumerate(self.params):
            p.data = self.param_view(i)

    def piece_views(self, flat_shard: torch.Tensor) -> List[torch.Tensor]:
        """The pieces' slices of a ``[S]`` tensor."""
        return [flat_shard[pc.a:pc.b] for pc in self.pieces]

    def scatter_values(self, values: Dict[str, torch.Tensor],
                       dtype=None) -> torch.Tensor:
        """A ``[total]`` buffer holding each named value at its offset
        (zeros elsewhere), in ``dtype`` (default the bucket's)."""
        from ...core.tree import as_tensor

        out = torch.zeros(self.total, dtype=dtype or self.dtype,
                          device=self.device)
        for i, name in enumerate(self.names):
            o, n = self.offsets[i], self.numels[i]
            out[o:o + n].copy_(as_tensor(values[name]).reshape(-1))
        return out

    def split_values(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each parameter's slice of a ``[total]`` buffer, by name, as a
        tensor of the parameter's shape (views)."""
        return {name: self.param_view(i, flat)
                for i, name in enumerate(self.names)}
