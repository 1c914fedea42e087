"""Process-level flag registry — counterpart of ``paddle_tpu.core.flags``,
kept to what the sanitizer reads (``FLAGS_check_nan_inf``).

A flag takes its value from the environment variable ``FLAGS_<name>``
when it is defined, and from ``set_flags`` afterwards; ``get_flags`` and
``flag_value`` read it back.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

__all__ = ["define_flag", "get_flags", "set_flags", "flag_value"]


class _Flag:
    __slots__ = ("name", "value", "default", "type", "help", "on_change")

    def __init__(self, name, default, help="", on_change=None):
        self.name = name
        self.default = default
        self.type = type(default)
        self.help = help
        self.on_change = on_change
        raw = os.environ.get(f"FLAGS_{name}")
        self.value = default if raw is None else _coerce(raw, self.type)


def _coerce(raw: str, typ) -> Any:
    if typ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    return raw


_registry: Dict[str, _Flag] = {}


def define_flag(name: str, default, help: str = "",
                on_change: Optional[Callable] = None) -> _Flag:
    if name in _registry:
        return _registry[name]
    f = _registry[name] = _Flag(name, default, help, on_change)
    return f


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _registry:
        raise KeyError(f"unknown flag {name!r}")
    return key


def get_flags(names) -> Dict[str, Any]:
    """``{"FLAGS_<name>": value}`` for one name or a list of names."""
    if isinstance(names, str):
        names = [names]
    return {f"FLAGS_{_key(n)}": _registry[_key(n)].value for n in names}


def set_flags(flags: Dict[str, Any]) -> None:
    for n, v in flags.items():
        f = _registry[_key(n)]
        if isinstance(v, str) and f.type is not str:
            v = _coerce(v, f.type)
        f.value = f.type(v)
        if f.on_change is not None:
            f.on_change(f.value)


def flag_value(name: str):
    return _registry[name].value


define_flag("check_nan_inf", False,
            "check every step's loss, gradients and parameters for NaN/Inf")
