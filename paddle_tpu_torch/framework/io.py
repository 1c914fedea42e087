"""``save`` / ``load`` — counterpart of ``paddle_tpu.framework.io``: pickle
a (nested) state dict whose tensors become numpy payloads, in the
reference's on-disk format.

A tensor is pickled as ``_TensorPayload``: its values as a numpy array
(``data``), ``name`` (the key it was saved under), ``stop_gradient`` (not
``requires_grad``) and ``is_parameter``. numpy has no bfloat16, so a
bf16 tensor is saved widened to f32 (exactly); loading it into a bf16
layer (``nn.set_state_dict``) casts it back to the same bits.

The port reads the reference's files: a ``.pdparams`` written by
``paddle_tpu.save`` pickles ``paddle_tpu.framework.io._TensorPayload``,
and the port's unpickler maps that class, by its name alone, to its own
payload class. It unpickles nothing else but numpy's array
reconstructors, ``collections.OrderedDict`` and plain builtins: any other
class raises ``pickle.UnpicklingError``. The reference cannot read the
port's files (its loader does not know the port's payload class).
``load(..., return_numpy=True)`` gives numpy arrays, otherwise CPU tensors
(``nn.Parameter`` for a saved parameter): the caller moves them.

Durability: every write commits atomically through
:func:`atomic_replace` (write a temp sibling, fsync, rename), so a crash
mid-save never leaves a torn file at the final path. On read, a file
beside a ``manifest.json`` that lists it is checked against its recorded
CRC32 and size first, and a mismatch raises
:class:`CheckpointIntegrityError`.

``save(..., cipher_key=key)`` writes the pickle AES-GCM encrypted
(``framework.io_crypto``, the reference's wire format); ``load`` detects
an encrypted file by its magic and needs the same ``cipher_key``. The
port reads the reference's encrypted files; the reference reads the
port's encrypted files whose leaves are numpy arrays and Python values
(a tensor leaf pickles the port's payload class, which it does not map).
"""
from __future__ import annotations

import io
import json
import os
import pickle
import zlib

import numpy as np
import torch
from torch import nn

from ..profiler import goodput as _goodput
from ..profiler import spans as _spans
from ..profiler.telemetry import get_telemetry

__all__ = ["save", "load", "atomic_replace", "file_crc32", "fsync_dir",
           "fsync_tree", "verify_against_manifest",
           "CheckpointIntegrityError", "MANIFEST_NAME"]

_PROTOCOL = 4

# The integrity record a coordinated checkpoint commits beside its
# shards: {"files": {<basename>: {"crc32": int, "size": int}}, ...}.
MANIFEST_NAME = "manifest.json"


class CheckpointIntegrityError(OSError):
    """A checkpoint file disagrees with its committed manifest (torn
    write, bit rot, post-commit corruption). The file is left in place:
    recovery is the caller's fallback to an older committed generation;
    deleting evidence here would destroy the forensics and any still-good
    sibling shards."""


def file_crc32(path, chunk_size=1 << 20) -> int:
    """Streaming CRC32 of a file (zlib, unsigned)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _fsync_file(path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path) -> None:
    """fsync a DIRECTORY so a just-renamed entry survives power loss —
    rename() orders the entry in memory only; the directory inode still
    needs its own flush. Best-effort on filesystems without dir fds."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def fsync_tree(root) -> None:
    """fsync every file and directory under ``root`` (a directory-valued
    checkpoint about to be commit-renamed)."""
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            try:
                _fsync_file(os.path.join(dirpath, name))
            except OSError:
                pass
        fsync_dir(dirpath)


def atomic_replace(path, write_fn) -> None:
    """The shared write-temp → fsync → rename commit helper: every
    checkpoint-bearing path routes through this, so no writer ever
    touches its final destination non-atomically. ``write_fn(tmp_path)``
    must create ``tmp_path``; on any failure the temp is removed and the
    previously committed file (if any) is untouched."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        write_fn(tmp)
        _fsync_file(tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass
        raise
    fsync_dir(os.path.dirname(path))


def verify_against_manifest(path):
    """If ``path`` sits beside a ``manifest.json`` that lists its
    basename, check recorded size + CRC32. Returns True when verified,
    None when no manifest covers the file, and raises
    :class:`CheckpointIntegrityError` on any mismatch (or an unreadable
    manifest — an integrity record you cannot read protects nothing)."""
    path = os.path.abspath(path)
    man_path = os.path.join(os.path.dirname(path), MANIFEST_NAME)
    if not os.path.exists(man_path):
        return None
    try:
        with open(man_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointIntegrityError(
            f"unreadable checkpoint manifest {man_path}: {e}")
    entry = (manifest.get("files") or {}).get(os.path.basename(path))
    if entry is None:
        return None  # manifest present but does not cover this file
    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise CheckpointIntegrityError(
            f"{path} listed in {man_path} but unreadable: {e}")
    if int(entry.get("size", -1)) != size:
        raise CheckpointIntegrityError(
            f"{path}: size {size} != manifest {entry.get('size')} "
            f"(torn write?) — fall back to the last committed-good "
            f"checkpoint generation")
    try:
        crc = file_crc32(path)
    except OSError as e:
        # EIO / EACCES / stale NFS handle mid-read: as unreadable as a
        # missing shard — must fall back, not crash the restore
        raise CheckpointIntegrityError(
            f"{path} listed in {man_path} but unreadable: {e}")
    if int(entry.get("crc32", -1)) != crc:
        raise CheckpointIntegrityError(
            f"{path}: crc32 {crc:#010x} != manifest "
            f"{int(entry.get('crc32', 0)):#010x} (corrupt shard) — fall "
            f"back to the last committed-good checkpoint generation")
    return True


class _TensorPayload:
    """Pickle payload holding numpy data and the tensor's metadata (the
    reference's layout)."""

    def __init__(self, t: torch.Tensor, name=None):
        data = t.detach().cpu()
        if data.dtype == torch.bfloat16:
            data = data.float()
        self.data = data.numpy()
        self.name = name
        self.stop_gradient = not t.requires_grad
        self.is_parameter = isinstance(t, nn.Parameter)


def _to_saveable(obj, name=None):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj, name)
    if isinstance(obj, dict):
        return type(obj)((k, _to_saveable(v, k)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _from_saveable(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        if return_numpy:
            return obj.data
        t = torch.from_numpy(np.array(obj.data))  # own, writable copy
        if obj.is_parameter:
            return nn.Parameter(t, requires_grad=not obj.stop_gradient
                                and t.is_floating_point())
        return t
    if isinstance(obj, dict):
        return type(obj)((k, _from_saveable(v, return_numpy))
                         for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saveable(v, return_numpy) for v in obj)
    return obj


# what a checkpoint may name: the payload classes of both packages, numpy's
# array and scalar reconstructors, OrderedDict and plain builtins
_PAYLOAD_CLASSES = {("paddle_tpu.framework.io", "_TensorPayload"),
                    (__name__, "_TensorPayload")}
_NUMPY_MODULES = {"numpy", "numpy.core.multiarray", "numpy._core.multiarray"}
_NUMPY_NAMES = {"_reconstruct", "ndarray", "dtype", "scalar"}
_SAFE_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int",
                  "float", "complex", "bool", "str", "bytes", "bytearray",
                  "slice", "range"}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _PAYLOAD_CLASSES:
            return _TensorPayload
        if (module in _NUMPY_MODULES and name in _NUMPY_NAMES) or (
                module == "collections" and name == "OrderedDict") or (
                module == "builtins" and name in _SAFE_BUILTINS):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint refers to {module}.{name}, which a checkpoint may "
            "not hold (only tensor payloads, numpy arrays and builtins)")


def save(obj, path, protocol=_PROTOCOL, **configs):
    """Pickle ``obj`` (a tensor, or nested dicts, lists and tuples of
    tensors and Python values) to ``path``, atomically; encrypted with
    ``cipher_key`` (AES key bytes) when it is given."""
    tel = get_telemetry()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with _spans.span("checkpoint", cat="checkpoint"), \
            tel.timer("checkpoint/write_ms"), \
            _goodput.activity("checkpoint_save"):
        payload = _to_saveable(obj)
        key = configs.get("cipher_key")
        if key is not None:
            from .io_crypto import AESCipher

            blob = pickle.dumps(payload, protocol=protocol)
            atomic_replace(
                path, lambda tmp: AESCipher(key).encrypt_to_file(blob, tmp))
        else:
            def _write(tmp):
                with open(tmp, "wb") as f:
                    pickle.dump(payload, f, protocol=protocol)

            atomic_replace(path, _write)
    tel.counter("checkpoint/writes")
    tel.counter("checkpoint/write_bytes", os.path.getsize(path))


def load(path, **configs):
    """The object ``save`` wrote to ``path`` (or the reference's
    ``paddle_tpu.save``), tensors on the CPU (numpy arrays with
    ``return_numpy=True``). A file covered by a sibling ``manifest.json``
    is verified first (``verify=False`` skips that for a caller that has
    already hashed it). An encrypted file needs its ``cipher_key``."""
    from .io_crypto import AESCipher, is_encrypted

    tel = get_telemetry()
    return_numpy = configs.get("return_numpy", False)
    with tel.timer("ckpt/restore_ms"), \
            _goodput.activity("checkpoint_restore"):
        if configs.get("verify", True) and verify_against_manifest(path):
            tel.counter("ckpt/manifest_verified")
        with _spans.span("checkpoint", cat="checkpoint"), \
                tel.timer("checkpoint/read_ms"):
            if is_encrypted(path):
                key = configs.get("cipher_key")
                if key is None:
                    raise ValueError(f"{path} is encrypted; pass "
                                     "cipher_key=<bytes> to load it")
                payload = _Unpickler(io.BytesIO(
                    AESCipher(key).decrypt_from_file(path))).load()
            else:
                with open(path, "rb") as f:
                    payload = _Unpickler(f).load()
            out = _from_saveable(payload, return_numpy)
    tel.counter("checkpoint/reads")
    tel.counter("checkpoint/read_bytes", os.path.getsize(path))
    return out
