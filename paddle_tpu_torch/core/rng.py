"""Random state — counterpart of ``paddle_tpu.core.rng``.

A ``Generator`` is a seed and one ``torch.Generator`` per device, each
made at its first use from that seed. The tensor API's random functions
draw from ``default_generator()``'s ``torch.Generator`` for the device
they make their tensor on. ``seed(s)`` reseeds every device and the
initializers' generator (``nn.initializer.seed``), so that one call gives
the same weights and the same draws on every run.

torch's streams are not JAX's: a seed gives other numbers than the
reference's, and what carries over is determinism, the state round trip
and the distributions. ``RNGStatesTracker`` keeps named generators for
tensor-parallel regions (``rng_state(name)`` makes one the default for a
block).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List

import torch

from .place import current_device, place_to_device

__all__ = ["Generator", "default_generator", "seed", "get_rng_state",
           "set_rng_state", "get_cuda_rng_state", "set_cuda_rng_state",
           "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed"]


def _key(device) -> torch.device:
    dev = place_to_device(device) if device is not None else current_device()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Generator:
    """A seed and one ``torch.Generator`` per device."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._gens: Dict[torch.device, torch.Generator] = {}
        self._lock = threading.Lock()

    def manual_seed(self, seed: int) -> "Generator":
        with self._lock:
            self._seed = int(seed)
            for g in self._gens.values():
                g.manual_seed(self._seed)
        return self

    def initial_seed(self) -> int:
        return self._seed

    def torch_generator(self, device=None) -> torch.Generator:
        """The ``torch.Generator`` of ``device`` (default: the current
        device)."""
        dev = _key(device)
        with self._lock:
            g = self._gens.get(dev)
            if g is None:
                g = self._gens[dev] = torch.Generator(device=dev)
                g.manual_seed(self._seed)
            return g

    def get_state(self, device=None) -> torch.Tensor:
        return self.torch_generator(device).get_state()

    def set_state(self, state: torch.Tensor, device=None) -> None:
        self.torch_generator(device).set_state(state)


_default = Generator(0)


def default_generator() -> Generator:
    return _default


def seed(s: int) -> Generator:
    """Seed every device's generator and the initializers' generator."""
    from ..nn import initializer

    _default.manual_seed(s)
    initializer.seed(s)
    return _default


def get_rng_state(device=None) -> torch.Tensor:
    """The state of the current device's generator."""
    return _default.get_state(device)


def set_rng_state(state, device=None) -> None:
    _default.set_state(state, device)


def get_cuda_rng_state() -> List[torch.Tensor]:
    """One state per card, in device order."""
    return [_default.get_state(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state_list) -> None:
    """Restore what ``get_cuda_rng_state`` returned."""
    if not isinstance(state_list, (list, tuple)):
        raise ValueError("set_cuda_rng_state expects the list that "
                         "get_cuda_rng_state returned")
    if len(state_list) != torch.cuda.device_count():
        raise ValueError(f"{len(state_list)} states for "
                         f"{torch.cuda.device_count()} cards")
    for i, st in enumerate(state_list):
        _default.set_state(st, f"cuda:{i}")


class RNGStatesTracker:
    """Named generators for tensor-parallel regions: ``rng_state(name)``
    makes one the default generator for a block, so that dropout masks
    differ (or match) across model-parallel ranks by construction."""

    def __init__(self):
        self._states: Dict[str, Generator] = {}

    def reset(self) -> None:
        self._states.clear()

    def add(self, name: str, seed_: int) -> None:
        if name in self._states:
            raise ValueError(f"rng state {name!r} already exists")
        self._states[name] = Generator(seed_)

    def get_states_tracker(self) -> Dict[str, torch.Tensor]:
        return {n: g.get_state() for n, g in self._states.items()}

    def set_states_tracker(self, states) -> None:
        for n, s in states.items():
            self._states.setdefault(n, Generator(0)).set_state(s)

    @contextlib.contextmanager
    def rng_state(self, name: str = "model_parallel_rng"):
        if name not in self._states:
            raise ValueError(f"rng state {name!r} was not added")
        global _default
        prev, _default = _default, self._states[name]
        try:
            yield
        finally:
            _default = prev


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker


def model_parallel_random_seed(seed_: int = 0, mp_rank: int = 0) -> None:
    """Seed the global generator and the named model-parallel domains."""
    global_seed = 100 + seed_
    local_seed = seed_ + 1024 + mp_rank * 100
    _tracker.reset()
    seed(global_seed)
    _tracker.add("model_parallel_rng", local_seed)
    _tracker.add("global_seed", global_seed)
