"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` — one
``nvcc`` process per source, all started together — and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use (never at import), into
``build/paddle_tpu_torch/`` beside the package, and is keyed by a digest
of the flags and of every ``csrc/`` file (sources and the ``*.cuh``
headers they include) so an edited source or header rebuilds.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises with CUDA's message when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

__all__ = ["BUILD_DIR", "SOURCES", "build", "library", "check", "stream_of",
           "DTYPE_CODES", "build_info"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "paddle_tpu_torch"
SOURCES = ("errors.cu", "layer_norm.cu", "layer_norm_bwd.cu",
           "flash_attn_fwd.cu", "flash_attn_bwd.cu", "adam.cu",
           "dkv_packed.cu", "tree_reduce.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# dtype codes of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build in this process did: seconds, library path, nvcc's
# per-source output (ptxas registers / shared memory / spills)
build_info: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# q, k, v, o, lse, key_bias (null: none), B, L, H, D, strides, scale,
# dtype, stream
_FLASH_FWD = ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
               _LL, _LL, _LL, _LL, _LL, _LL, _F, _I, _P], _I)
# q, k, v, out, dout, lse, delta, key_bias, out0, out1, B, L, H, D,
# strides (q, k, v, dout, out), scale, dtype, stream
_FLASH_BWD = ([_P] * 10 + [_I] * 4 + [_LL] * 10 + [_F, _I, _P], _I)
_SIGNATURES = {
    "ptt_error_string": ([_I], ctypes.c_char_p),
    # x, w, b, y, rows, hidden, rows_per_block, grid, eps, dtype, variant,
    # stream
    "ptt_layer_norm_fwd": ([_P] * 4 + [_I] * 4 + [_F, _I, _I, _P], _I),
    "ptt_flash_attn_fwd": _FLASH_FWD,
    "ptt_flash_attn_fwd_full": _FLASH_FWD,
    # x, w, g, dx, dw_part, db_part, dw, db, rows, hidden, rows_per_block,
    # grid, eps, dtype, variant, stream
    "ptt_layer_norm_bwd": ([_P] * 8 + [_I] * 4 + [_F, _I, _I, _P], _I),
    "ptt_flash_attn_bwd_dq": _FLASH_BWD,
    "ptt_flash_attn_bwd_dkv": _FLASH_BWD,
    "ptt_flash_attn_bwd_dq_full": _FLASH_BWD,
    "ptt_flash_attn_bwd_dkv_full": _FLASH_BWD,
    # tab, grads, chunks, nchunks, ntensors, lr, clip scale (null: none),
    # ok word (null: ungated), b1, b2, 1 - b1, 1 - b2, eps, chunk, stream
    "ptt_adam_step": ([_P, _P, _P, _I, _I, _P, _P, _P, _F, _F, _F, _F, _F,
                       _I, _P], _I),
    # tab, grads, chunks, nchunks, ntensors, starts, lr, clip scale, loss,
    # b1, b2, 1 - b1, 1 - b2, eps, chunk, partials, flags, ok, stream
    "ptt_adam_check": ([_P, _P, _P, _I, _I, _P, _P, _P, _P, _F, _F, _F, _F,
                        _F, _I, _P, _P, _P, _P], _I),
    # tab, grads, chunks, nchunks, partials, out, clip, chunk, stream
    "ptt_grad_sumsq": ([_P, _P, _P, _I, _P, _P, _F, _I, _P], _I),
    "ptt_dkv_packed": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P], _I),
    # tab, chunks, nchunks, leaf_chunks, nleaves, chunk, mode, partials,
    # out_sums, out_xor, flags, stream
    "ptt_tree_reduce": ([_P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P],
                        _I),
}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _digest() -> str:
    """Hash of the flags and of every source and header under ``CSRC``
    (a header is compiled into each source that includes it)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the library; returns its
    path. A library already built from the same sources is reused."""
    so = BUILD_DIR / f"libpaddle_tpu_torch_{_digest()}.so"
    if so.exists():
        build_info.update(seconds=0.0, path=str(so), log={})
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
    t0 = time.perf_counter()
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (Path(name).stem + ".o")
            log = open(tmp / (name + ".log"), "w+")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, log,
                          subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT)))
        logs, failed = {}, []
        for name, _, log, proc in procs:
            rc = proc.wait()
            log.seek(0)
            logs[name] = log.read()
            log.close()
            if rc != 0:
                failed.append(name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        out = tmp / so.name
        link = subprocess.run(
            [nvcc, "-shared", *(str(o) for _, o, _, _ in procs),
             "-o", str(out)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("linking the kernels failed:\n"
                               + link.stdout + link.stderr)
        os.replace(out, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(seconds=time.perf_counter() - t0, path=str(so),
                      log=logs)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, (args, res) in _SIGNATURES.items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().ptt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def refuse_trace(t: torch.Tensor, what: str) -> None:
    """Raise when ``t`` is a fake tensor: an export traced a kernel's
    wrapper instead of its registered op, and its program would run the
    plain version."""
    from torch._subclasses.fake_tensor import is_fake

    if is_fake(t):
        raise RuntimeError(
            f"{what}: an export traced the wrapper, not its registered op; "
            "the exported program would run the plain version")
