"""The training step's finite sweep and state fingerprint — counterpart of
``paddle_tpu.core.sanitizer``.

These are plain PyTorch functions over trees of tensors (``core.tree``:
dicts walked in sorted-key order). They are what the CPU path runs and
the plain versions that the card's kernels are held against: on the card
the engines take the sweep from the Adam kernel's check pass
(``ops.fused.adam_finite_check``) or from the multi-tensor walker
(``ops.tree_reduce``), and the fingerprint from the walker's fold mode.

- ``finite_flags(names, **groups)``: one ``isfinite().all()`` per float
  leaf (``loss``, ``grad['fc.weight']``, ...: the reference's leaf names),
  stacked into one bool tensor that stays on the device;
- ``select_if_finite(flags, new, old)``: every leaf of ``new`` where all
  flags hold, else its ``old`` twin;
- ``tree_fingerprint(*trees)``: an f32 sum and abs-sum of every float leaf
  and a bit-exact 32-bit XOR word of every leaf (its raw bits, 1- and
  2-byte types widened to 32 bits, 8-byte types as two words, complex
  values as their real and imaginary parts), the leaves chained by
  rotate-left-1 then XOR. torch has no XOR reduction and few ``uint32``
  operations, so a leaf's words are XOR-folded in int32 by halving and
  the chain runs in int64 masked to 32 bits; the word is an int64 tensor
  holding the unsigned value.

``jit_check_enabled()`` reads ``FLAGS_check_nan_inf`` when an engine is
built; ``finite_report`` and ``raise_if_nonfinite`` read the flags on the
host.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .flags import flag_value
from .tree import as_tensor, flatten_with_path, leaves, tree_map

__all__ = ["jit_check_enabled", "finite_flags", "finite_report",
           "raise_if_nonfinite", "select_if_finite", "tree_fingerprint",
           "zero_fingerprint", "xor_fold_leaf", "float_leaf"]

_MASK32 = 0xFFFFFFFF


def jit_check_enabled() -> bool:
    """``FLAGS_check_nan_inf``, read when a step is built."""
    return bool(flag_value("check_nan_inf"))


def float_leaf(t: torch.Tensor) -> bool:
    """A floating or complex tensor (the reference's ``inexact``)."""
    return t.is_floating_point() or t.is_complex()


def finite_flags(names_out: list, **groups) -> Optional[torch.Tensor]:
    """One ``isfinite().all()`` per float leaf of each group (a tree),
    stacked into a bool tensor on the leaves' device (None when there is
    no float leaf). ``names_out`` is cleared and filled with the leaves'
    names, ``f"{group}{keystr}"``."""
    names_out.clear()
    flags = []
    for gname, tree in groups.items():
        for path, leaf in flatten_with_path(tree):
            leaf = as_tensor(leaf)
            if float_leaf(leaf):
                names_out.append(f"{gname}{path}")
                flags.append(torch.isfinite(leaf).all())
    return torch.stack(flags) if flags else None


def select_if_finite(flags: torch.Tensor, new_tree, old_tree):
    """Every leaf of ``new_tree`` where all ``flags`` hold, else its twin
    in ``old_tree`` (a ``torch.where`` on the device: no host sync)."""
    ok = flags.all()
    new_leaves = leaves(new_tree)
    old_leaves = leaves(old_tree)
    if len(new_leaves) != len(old_leaves):
        raise ValueError("select_if_finite: the trees differ")
    picked = iter([torch.where(ok, a, b)
                   for a, b in zip(new_leaves, old_leaves)])
    return tree_map(lambda _: next(picked), new_tree)


def _words(t: torch.Tensor) -> torch.Tensor:
    """The leaf's raw bits as int32 words: 1- and 2-byte elements widened
    (zero-extended), 4-byte ones as they are, 8-byte ones as two words."""
    if t.is_complex():
        t = torch.cat([t.real.reshape(-1), t.imag.reshape(-1)])
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    t = t.reshape(-1).contiguous()
    size = t.element_size()
    if size == 1:
        return t.view(torch.uint8).to(torch.int32)
    if size == 2:
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t.view(torch.int32)


def xor_fold_leaf(leaf: torch.Tensor) -> torch.Tensor:
    """The XOR of every 32-bit word of ``leaf`` (see ``_words``), as a 0-d
    int64 tensor in [0, 2**32): every flipped bit in the leaf flips it."""
    w = _words(as_tensor(leaf))
    if w.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=w.device)
    while w.numel() > 1:
        if w.numel() % 2:
            w = torch.cat([w, w.new_zeros(1)])
        half = w.numel() // 2
        w = torch.bitwise_xor(w[:half], w[half:])
    return w.reshape(()).to(torch.int64) & _MASK32


def zero_fingerprint(device=None) -> Dict[str, torch.Tensor]:
    return {"sum": torch.zeros((), dtype=torch.float32, device=device),
            "abs_sum": torch.zeros((), dtype=torch.float32, device=device),
            "xor": torch.zeros((), dtype=torch.int64, device=device)}


def tree_fingerprint(*trees) -> Dict[str, torch.Tensor]:
    """Fold every leaf of ``trees`` into ``{"sum", "abs_sum", "xor"}``: f32
    sums of the float leaves (each cast to f32 first; a complex leaf's real
    part, as the reference's cast keeps it) and the rotate-then-XOR chain
    of every leaf's ``xor_fold_leaf``, in flatten order. The results stay
    on the leaves' device."""
    all_leaves = [as_tensor(leaf) for tree in trees for leaf in leaves(tree)]
    dev = all_leaves[0].device if all_leaves else None
    fp = zero_fingerprint(dev)
    total, abs_total, xor_total = fp["sum"], fp["abs_sum"], fp["xor"]
    for leaf in all_leaves:
        if float_leaf(leaf):
            f = (leaf.real if leaf.is_complex() else leaf).float()
            total = total + f.sum()
            abs_total = abs_total + f.abs().sum()
        xor_total = (((xor_total << 1) | (xor_total >> 31)) & _MASK32) \
            ^ xor_fold_leaf(leaf)
    return {"sum": total, "abs_sum": abs_total, "xor": xor_total}


def finite_report(names: List[str], flags) -> tuple:
    """``(ok, bad_names)`` from the sweep's flags, read on the host
    (``flags is None``: nothing was checked, ok)."""
    if flags is None:
        return True, []
    ok = as_tensor(flags).detach().cpu().reshape(-1).tolist()
    if all(ok):
        return True, []
    return False, [n for n, f in zip(names, ok) if not f]


def raise_if_nonfinite(names: List[str], flags, loss_scale=None) -> None:
    """Raise a ``FloatingPointError`` naming every non-finite leaf, with
    the loss scale in effect (when an AMP scaler has set one) and the
    recovery hint; counts ``resilience/nonfinite_steps``."""
    all_ok, bad = finite_report(names, flags)
    if all_ok:
        return
    from ..profiler.telemetry import get_telemetry

    get_telemetry().counter("resilience/nonfinite_steps")
    shown = ", ".join(bad[:8]) + (f" (+{len(bad) - 8} more)" if len(bad) > 8
                                  else "")
    if loss_scale is None:
        from ..amp.grad_scaler import current_loss_scale

        loss_scale = current_loss_scale()
    scale_note = (f" (loss_scale={float(loss_scale):g})"
                  if loss_scale is not None else "")
    raise FloatingPointError(
        f"FLAGS_check_nan_inf: NaN or Inf detected in compiled step: "
        f"{shown}{scale_note}. For skip/rollback recovery instead of "
        f"aborting, wrap the step in paddle_tpu_torch.resilience.StepGuard "
        f"(engine arg guard_updates=True).")
