"""Blocked / paged KV-cache pool — counterpart of
``paddle_tpu.inference.serving.kv_cache``.

- device side: ``pages['k'] / pages['v']`` are
  ``[num_layers, num_blocks, block_size, heads, head_dim]`` tensors on
  the pool's device; a token at logical position ``p`` of a sequence
  lives in page ``block_table[p // block_size]`` at slot
  ``p % block_size``. The decode step writes them in place.
- host side: a free list plus an owner map; accounting is exact —
  ``used_blocks`` returns to 0 after a drain.

- int8 storage (``dtype='int8'``): K/V quantize on write through
  ``quant.quantize_kv`` (one f32 scale per token-head, in
  ``pages['k_scale'] / pages['v_scale']``, [num_layers, num_blocks,
  block_size, heads]) and dequantize one page pair at a time inside the
  paged attention: the cache takes about half a bf16 pool's bytes.

Page 0 is a reserved **scratch page**: never allocated, it takes every
masked-out write (padding rows of a bucketed batch, padded tail of a
prefill chunk), so the scatter needs no data-dependent guard.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ...core.place import resolve_device
from ...profiler.telemetry import get_telemetry

__all__ = ["KVCacheConfig", "KVCachePool", "SCRATCH_PAGE"]

SCRATCH_PAGE = 0

_STORE_DTYPES = ("float32", "bfloat16", "int8")


class KVCacheConfig:
    """Geometry + storage dtype of one pool.

    Args:
        num_layers/num_heads/head_dim: the served model's KV shape.
        num_blocks: pool capacity in blocks (one is reserved as scratch).
        block_size: tokens per block.
        dtype: 'float32' | 'bfloat16' | 'int8' storage; int8 adds the
            per-token-head scale planes.
    """

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 num_blocks: int = 64, block_size: int = 16,
                 dtype: str = "float32"):
        if dtype not in _STORE_DTYPES:
            raise ValueError(f"kv dtype {dtype!r} not in {_STORE_DTYPES}")
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (page 0 is scratch)")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.dtype = dtype

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1  # minus the scratch page

    def blocks_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_size)


class KVCachePool:
    """One device pool + its host-side block accounting. ``device``
    defaults to ``"cuda"``."""

    def __init__(self, config: KVCacheConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.config = config
        c = config
        self.device = resolve_device(device)
        shape = (c.num_layers, c.num_blocks, c.block_size, c.num_heads,
                 c.head_dim)
        store = getattr(torch, c.dtype)
        self.pages: Dict[str, torch.Tensor] = {
            "k": torch.zeros(shape, dtype=store, device=self.device),
            "v": torch.zeros(shape, dtype=store, device=self.device),
        }
        if c.dtype == "int8":  # one f32 scale per token-head
            for name in ("k_scale", "v_scale"):
                self.pages[name] = torch.zeros(
                    shape[:-1], dtype=torch.float32, device=self.device)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(1, c.num_blocks))
        self._owned: Dict[int, List[int]] = {}  # request id -> block ids
        self._tel = get_telemetry()
        self._tel.gauge("serve/kv_blocks_total", c.usable_blocks)
        self._publish_locked()

    def _publish_locked(self) -> None:
        used = self.config.usable_blocks - len(self._free)
        self._tel.gauge("serve/kv_blocks_used", used)
        self._tel.gauge("serve/kv_occupancy",
                        used / max(self.config.usable_blocks, 1))

    def ensure(self, owner: int, n_tokens: int) -> bool:
        """Grow ``owner``'s block list to cover ``n_tokens`` positions.
        Returns False (allocating NOTHING) when the free list cannot
        cover the growth."""
        need = self.config.blocks_for(n_tokens)
        with self._lock:
            have = self._owned.setdefault(owner, [])
            grow = need - len(have)
            if grow <= 0:
                return True
            if grow > len(self._free):
                return False
            taken = [self._free.pop() for _ in range(grow)]
            have.extend(taken)
            self._tel.counter("serve/kv_blocks_alloc", len(taken))
            self._publish_locked()
            return True

    def release(self, owner: int) -> int:
        """Return every block of ``owner`` to the free list (idempotent).
        Returns the number freed."""
        with self._lock:
            blocks = self._owned.pop(owner, None)
            if not blocks:
                return 0
            self._free.extend(blocks)
            self._tel.counter("serve/kv_blocks_free", len(blocks))
            self._publish_locked()
            return len(blocks)

    def owned(self, owner: int) -> List[int]:
        with self._lock:
            return list(self._owned.get(owner, ()))

    @property
    def used_blocks(self) -> int:
        with self._lock:
            return self.config.usable_blocks - len(self._free)

    def nbytes(self) -> int:
        """Device bytes of the pages (scale planes included)."""
        return sum(t.numel() * t.element_size() for t in self.pages.values())

    def accounting(self) -> dict:
        """The leak ledger: after a drain ``leaked_blocks`` is 0 and
        ``owners`` empty."""
        with self._lock:
            used = self.config.usable_blocks - len(self._free)
            return {"total_blocks": self.config.usable_blocks,
                    "used_blocks": used,
                    "leaked_blocks": used,
                    "owners": sorted(self._owned)}

    def block_table(self, owner: int, width: int) -> np.ndarray:
        """``owner``'s page ids padded to ``width`` with the scratch page."""
        blocks = self.owned(owner)
        if len(blocks) > width:
            raise ValueError(f"owner {owner} holds {len(blocks)} blocks, "
                             f"table width is {width}")
        out = np.full(width, SCRATCH_PAGE, np.int32)
        out[:len(blocks)] = blocks
        return out
