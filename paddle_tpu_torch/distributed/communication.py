"""Eager host-side collectives — counterpart of
``paddle_tpu.distributed.communication``, kept to ``all_gather_object``
(the integrity monitor's fingerprint exchange) and the launcher's world
and rank.

``all_gather_object`` has two transports here: the world of one (the
object comes back alone) and a shared-filesystem rendezvous, which
threads or processes of one machine, or hosts sharing a filesystem, can
use. The reference's third, jax process collectives, becomes
``torch.distributed`` with the multi-device port; until then a world of
more than one with no rendezvous directory raises instead of hanging, and
a peer that never writes its part raises ``CollectiveTimeout``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Tuple

from ..framework.io import atomic_replace

__all__ = ["CollectiveTimeout", "launch_world_rank", "all_gather_object"]


class CollectiveTimeout(RuntimeError):
    """A cross-rank wait exceeded its deadline — some peer is dead or
    hung. The caller converts this into a restartable exit; blocking
    forever is the one unacceptable outcome."""


def launch_world_rank() -> Tuple[int, int]:
    """``(world, rank)`` from the launcher's environment
    (``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ID``; 1 and 0 when unset or
    unreadable)."""
    try:
        world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)
    except ValueError:
        world = 1
    try:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    except ValueError:
        rank = 0
    return world, rank


# this rank's file of its previous gather, by rendezvous directory
_prev_gather_file: Dict[tuple, str] = {}


def all_gather_object(obj, key, rendezvous_dir=None, timeout_s=120.0,
                      poll_s=0.05, rank=None, world_size=None,
                      cleanup_prev=False) -> list:
    """Gather one small JSON-serializable object from each rank; returns
    the ``world_size`` objects ordered by rank.

    In a world of one the object comes back alone. Otherwise each rank
    atomically writes ``<key>.rank<r>.json`` under ``rendezvous_dir``
    (default ``$PADDLE_TPU_INTEGRITY_DIR``) and polls for every peer's,
    raising ``CollectiveTimeout`` past ``timeout_s``. ``key`` must be
    unique per logical collective (callers key on the step).
    ``cleanup_prev=True`` removes this rank's file of its previous gather
    once the current one completes: every rank wrote this key only after
    reading all of the previous one, so that file is dead weight."""
    world, env_rank = launch_world_rank()
    if world_size is not None:
        world = int(world_size)
    r = env_rank if rank is None else int(rank)
    if world <= 1:
        return [obj]
    if rendezvous_dir is None:
        rendezvous_dir = os.environ.get("PADDLE_TPU_INTEGRITY_DIR")
    if not rendezvous_dir:
        raise RuntimeError(
            f"all_gather_object: world size {world} but no rendezvous_dir "
            f"(PADDLE_TPU_INTEGRITY_DIR) is set and torch.distributed "
            f"collectives are not ported yet — no transport can carry the "
            f"gather")
    os.makedirs(rendezvous_dir, exist_ok=True)
    mine = os.path.join(rendezvous_dir, f"{key}.rank{r}.json")
    data = json.dumps(obj)

    def _write(tmp):
        with open(tmp, "w") as f:
            f.write(data)

    atomic_replace(mine, _write)
    paths = [os.path.join(rendezvous_dir, f"{key}.rank{i}.json")
             for i in range(world)]
    deadline = time.monotonic() + float(timeout_s)
    while not all(os.path.exists(p) for p in paths):
        if time.monotonic() > deadline:
            missing = [i for i, p in enumerate(paths)
                       if not os.path.exists(p)]
            raise CollectiveTimeout(
                f"rank {r}: all_gather_object({key!r}) gave up waiting "
                f"for rank(s) {missing} after {timeout_s:.1f}s — a peer "
                f"rank is dead or hung")
        time.sleep(float(poll_s))
    out = []
    for p in paths:
        with open(p) as f:
            out.append(json.load(f))
    if cleanup_prev:
        prev = _prev_gather_file.get((rendezvous_dir, r))
        if prev and prev != mine:
            try:
                os.unlink(prev)
            except OSError:
                pass
        _prev_gather_file[(rendezvous_dir, r)] = mine
    return out
