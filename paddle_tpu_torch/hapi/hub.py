"""``hub`` — counterpart of ``paddle_tpu.hapi.hub``: ``list``, ``help``
and ``load`` of the model entry points in a local directory's
``hubconf.py`` (its public callables; ``dependencies = [...]`` names
modules that must be importable). The remote sources ('github',
'gitee') raise: nothing is downloaded.
"""
from __future__ import annotations

import importlib.util
import os
import sys

__all__ = ["list", "help", "load"]

_HUBCONF = "hubconf.py"


def _import_hubconf(repo_dir: str):
    if not os.path.isdir(repo_dir):
        raise ValueError(f"hub: {repo_dir!r} is not a directory")
    path = os.path.join(repo_dir, _HUBCONF)
    if not os.path.exists(path):
        raise FileNotFoundError(f"hub: no {_HUBCONF} in {repo_dir!r}")
    spec = importlib.util.spec_from_file_location("paddle_tpu_torch_hubconf",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, repo_dir)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(repo_dir)
    for dep in getattr(mod, "dependencies", []):
        if importlib.util.find_spec(dep) is None:
            raise RuntimeError(f"hub: missing dependency {dep!r} required "
                               f"by {path}")
    return mod


def _check_source(source: str):
    if source != "local":
        raise ValueError(
            f"hub source {source!r} needs the network, which this package "
            "does not use; clone the repo yourself and use source='local'")


def _entry(mod, repo_dir, model):
    fn = getattr(mod, model, None)
    if fn is None or not callable(fn):
        raise ValueError(f"hub: no entry point {model!r} in {repo_dir!r}")
    return fn


def list(repo_dir, source="local", force_reload=False):
    """Names of the model entry points of the repo's hubconf."""
    _check_source(source)
    return [n for n, v in vars(_import_hubconf(repo_dir)).items()
            if callable(v) and not n.startswith("_")]


def help(repo_dir, model, source="local", force_reload=False):
    """The docstring of one entry point."""
    _check_source(source)
    return _entry(_import_hubconf(repo_dir), repo_dir, model).__doc__


def load(repo_dir, model, source="local", force_reload=False, **kwargs):
    """The model that the entry point ``model`` builds from ``kwargs``."""
    _check_source(source)
    return _entry(_import_hubconf(repo_dir), repo_dir, model)(**kwargs)
