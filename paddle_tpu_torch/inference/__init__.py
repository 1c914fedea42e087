"""``paddle_tpu_torch.inference`` — the deployment path, counterpart of
``paddle_tpu.inference``: ``Config`` → ``create_predictor`` → named input
and output handles → ``predictor.run()``.

A Predictor serves either a live layer (``Config.set_layer``: the
layer's eager forward, in eval mode and without gradients) or a
``.pdexport`` artifact that ``jit.save(layer, prefix, input_spec=...)``
or ``static.save_inference_model`` wrote (``Config(prefix)``: the loaded
``torch.export`` program, no model code needed). Both run the kernels on
the card: the layer through its modules, the artifact through the
registered kernel ops its graph holds (``inference/_export.py``).

The Predictor runs on the card (``enable_use_gpu``, the default) and
raises without one; ``Config.disable_gpu()`` asks for the CPU. A live
layer must already live on that device (nothing moves silently); an
artifact's weights must have been exported there.

Precision: ``set_precision(PrecisionType.Bfloat16 | Half)`` on a live
layer serves a copy of it cast to that dtype, casts the float inputs at
each call, and returns float32 outputs; an artifact's dtype is
baked at export (``jit.save(..., precision=...)``) and a Config asking
for another one raises, both ways, as in the reference.
"""
from __future__ import annotations

import copy
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["Config", "Predictor", "create_predictor",
           "create_predictor_from_path", "PrecisionType"]

_CASTS = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class PrecisionType:
    Float32 = "float32"
    Bfloat16 = "bfloat16"
    Half = "float16"
    Int8 = "int8"  # accepted as in the reference; serves the float model


class Config:
    """The reference's ``Config``: the model source, the device and the
    precision. ``model_path`` is the prefix of ``<prefix>.pdexport``;
    ``params_path`` is accepted as in the reference (the artifact holds
    its weights)."""

    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        self.model_path = model_path
        self._device = "cuda"
        self._precision = PrecisionType.Float32
        self._precision_explicit = False
        self._layer = None
        self._input_spec = None

    # -- device ---------------------------------------------------------------
    def enable_use_gpu(self, memory_pool_mb: int = 100, device_id: int = 0):
        self._device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self) -> bool:
        return self._device != "cpu"

    def set_precision(self, p: str):
        self._precision = p
        self._precision_explicit = True

    # -- model source ---------------------------------------------------------
    def set_model(self, model_path: str, params_path: Optional[str] = None):
        self.model_path = model_path

    def set_layer(self, layer, input_spec=None):
        """Serve ``layer`` itself (no files)."""
        self._layer = layer
        self._input_spec = input_spec


class _IOHandle:
    """Zero-copy tensor handle. Writes land in a thread-local and a shared
    slot; reads prefer the calling thread's, so a thread running
    ``copy_from_cpu`` → ``run()`` → ``copy_to_cpu`` reads back its own
    outputs while other threads run the same predictor."""

    def __init__(self, name: str):
        self.name = name
        self._shared: Optional[np.ndarray] = None
        self._tls = threading.local()

    def _get(self) -> Optional[np.ndarray]:
        return getattr(self._tls, "array", self._shared)

    def _set(self, arr: np.ndarray):
        self._tls.array = arr
        self._shared = arr

    def copy_from_cpu(self, arr: np.ndarray):
        self._set(np.asarray(arr))

    def reshape(self, shape):
        cur = self._get()
        self._set(np.zeros(shape, np.float32) if cur is None
                  else cur.reshape(shape))

    def copy_to_cpu(self) -> np.ndarray:
        return np.asarray(self._get())

    @property
    def shape(self):
        arr = self._get()
        return None if arr is None else arr.shape


def _spec_parts(spec) -> Tuple[list, torch.dtype, Optional[str]]:
    """(shape, torch dtype, name) of an InputSpec or a tensor-like."""
    from ..static.program import convert_dtype

    return (list(spec.shape), convert_dtype(getattr(spec, "dtype", None)),
            getattr(spec, "name", None))


def _sample_spec(shape, dtype):
    """(per-sample shape, numpy dtype), or None when a non-batch dim is
    dynamic. Axis 0 is the batch axis the serving scheduler packs."""
    dims = tuple(shape)[1:]
    if not all(isinstance(d, int) and d >= 0 for d in dims):
        return None
    return tuple(int(d) for d in dims), _numpy_dtype(dtype)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy has no bfloat16: such inputs are submitted as float32 and
    cast on the device."""
    if dtype == torch.bfloat16:
        return np.dtype("float32")
    return torch.empty(0, dtype=dtype).numpy().dtype


def _as_tuple(out) -> tuple:
    return tuple(out) if isinstance(out, (list, tuple)) else (out,)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """An output on the host (bf16 and f16 widened to f32)."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def _module_device(module) -> Optional[torch.device]:
    for t in list(module.parameters()) + list(module.buffers()):
        return t.device
    return None


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


class Predictor:
    def __init__(self, config: Config):
        from ..core.place import resolve_device

        self._config = config
        self.device = resolve_device(config._device)
        self._input_names: List[str] = []
        self._output_names: List[str] = []
        self._inputs: Dict[str, _IOHandle] = {}
        self._outputs: Dict[str, _IOHandle] = {}
        # guards the shared handles; a run with a full inputs list shares
        # nothing on the way in
        self._lock = threading.Lock()
        self._serving_raw = None
        self._sample_specs_list = None
        self._in_dtypes: List[torch.dtype] = []
        self.serving_dtype = "float32"
        self.exported = None  # the loaded ExportedProgram (artifact mode)
        if config._layer is not None:
            self._init_from_layer(config._layer, config._input_spec)
        elif config.model_path:
            self._init_from_files(config.model_path)
        else:
            raise ValueError("Config needs set_model(path) or set_layer(layer)")
        self.serving_dtype_bits = 16 if self.serving_dtype in _CASTS else 32
        from ..profiler.telemetry import get_telemetry

        get_telemetry().gauge("serve/dtype_bits", self.serving_dtype_bits)

    # -- loading ----------------------------------------------------------------
    def _init_from_files(self, prefix: str):
        from ._export import read_pdexport

        export_path = prefix + ".pdexport"
        if not os.path.exists(export_path):
            raise FileNotFoundError(
                f"{export_path} not found — produce it with "
                "paddle_tpu_torch.jit.save(layer, prefix, input_spec=[...])")
        ep, meta = read_pdexport(export_path)
        artifact_dtype = meta["dtype"]
        want = self._config._precision
        explicit_f32 = (want == PrecisionType.Float32
                        and self._config._precision_explicit)
        if (want in _CASTS or explicit_f32) and artifact_dtype != want:
            raise ValueError(
                f"Config requests {want} but {export_path} was exported "
                f"with {artifact_dtype} weights baked in — re-export with "
                f"jit.save(layer, prefix, input_spec, precision={want!r}) "
                "or serve the live layer via Config.set_layer, which casts "
                "at load")
        weights = list(ep.state_dict.values()) + list(ep.constants.values())
        dev = next((t.device for t in weights
                    if isinstance(t, torch.Tensor)), self.device)
        if not _same_device(dev, self.device):
            raise ValueError(
                f"{export_path} holds weights on {dev}, the Config asks for "
                f"{self.device} (export on the device that serves it)")
        self.serving_dtype = artifact_dtype
        self.exported = ep
        self.kernel_ops = dict(meta.get("kernel_ops", {}))
        self._input_names = list(meta["input_names"])
        self._output_names = list(meta["output_names"])
        from ..static.program import convert_dtype

        specs = [(shape, convert_dtype(dt)) for shape, dt in meta["in_specs"]]
        self._in_dtypes = [dt for _, dt in specs]
        samples = [_sample_spec(shape, dt) for shape, dt in specs]
        self._sample_specs_list = None if any(s is None for s in samples) \
            else samples
        module = ep.module()

        def raw(*tensors):
            with torch.no_grad():
                return _as_tuple(module(*tensors))

        self._serving_raw = raw
        self._make_handles()

    def _init_from_layer(self, layer, input_spec):
        dev = _module_device(layer)
        if dev is not None and not _same_device(dev, self.device):
            raise ValueError(
                f"the layer's parameters are on {dev}, the Config asks for "
                f"{self.device}: move the layer first")
        layer.eval()
        cast = _CASTS.get(self._config._precision)
        if cast is not None:
            self.serving_dtype = self._config._precision
            served = copy.deepcopy(layer).to(cast)

            def call(*xs):
                xs = [x.to(cast) if x.is_floating_point() else x for x in xs]
                return tuple(o.float() if o.is_floating_point() else o
                             for o in _as_tuple(served(*xs)))
        else:
            def call(*xs):
                return _as_tuple(layer(*xs))

        def raw(*tensors):
            with torch.no_grad():
                return call(*tensors)

        self._serving_raw = raw
        specs = [_spec_parts(s) for s in (input_spec or ())]
        self._input_names = [name or f"x{i}"
                             for i, (_, _, name) in enumerate(specs)] or ["x0"]
        self._in_dtypes = [dt for _, dt, _ in specs]
        if specs:
            samples = [_sample_spec(shape, dt) for shape, dt, _ in specs]
            self._sample_specs_list = None if any(
                s is None for s in samples) else samples
            # count the outputs on a batch of one (dynamic dims at 1)
            probe = [torch.zeros([1 if not isinstance(d, int) or d < 0
                                  else d for d in shape], dtype=dt,
                                 device=self.device)
                     for shape, dt, _ in specs]
            n_out = len(raw(*probe))
        else:
            n_out = 1
        self._output_names = [f"output{i}" for i in range(n_out)]
        self._make_handles()

    def _make_handles(self):
        self._inputs = {n: _IOHandle(n) for n in self._input_names}
        self._outputs = {n: _IOHandle(n) for n in self._output_names}

    # -- the reference's predictor API ----------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_output_names(self) -> List[str]:
        return list(self._output_names)

    def get_input_handle(self, name: str) -> _IOHandle:
        return self._inputs[name]

    def get_output_handle(self, name: str) -> _IOHandle:
        return self._outputs[name]

    def _to_device(self, arrays) -> List[torch.Tensor]:
        out = []
        for i, a in enumerate(arrays):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a))
            if i < len(self._in_dtypes) and t.dtype != self._in_dtypes[i]:
                t = t.to(self._in_dtypes[i])
            out.append(t.to(self.device))
        return out

    def _execute(self, arrays: List[np.ndarray]) -> List[np.ndarray]:
        outs = [_to_numpy(o) for o in
                self._serving_raw(*self._to_device(arrays))]
        if len(outs) != len(self._output_names):
            raise RuntimeError(
                f"model returned {len(outs)} outputs but the predictor "
                f"declares {self._output_names}")
        return outs

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """Run on the input handles and fill the output handles; given
        ``inputs``, also return the outputs. A full ``inputs`` list shares
        nothing with other threads on the way in; the handle paths run
        under the predictor's lock."""
        if inputs is not None and len(inputs) == len(self._input_names):
            arrays = [np.asarray(a) for a in inputs]
            outs = self._execute(arrays)
            with self._lock:
                for n, a in zip(self._input_names, arrays):
                    self._inputs[n].copy_from_cpu(a)
                for n, o in zip(self._output_names, outs):
                    self._outputs[n].copy_from_cpu(o)
            return outs
        with self._lock:
            if inputs is not None:  # partial: merge into the handles
                for n, a in zip(self._input_names, inputs):
                    self._inputs[n].copy_from_cpu(a)
            arrays = []
            for n in self._input_names:
                arr = self._inputs[n]._get()
                if arr is None:
                    raise RuntimeError(
                        f"input '{n}' not set (copy_from_cpu first)")
                arrays.append(arr)
            outs = self._execute(arrays)
            for n, o in zip(self._output_names, outs):
                self._outputs[n].copy_from_cpu(o)
            return outs if inputs is not None else True

    # -- serving hooks (inference.serving.ServingEngine) ----------------------
    def serving_fn(self):
        """The batched callable the serving scheduler runs:
        ``fn(*batched) -> tuple`` of batched output tensors on the
        predictor's device (no copy to the host). Takes tensors or numpy
        arrays."""
        raw = self._serving_raw

        def fn(*arrays):
            return raw(*self._to_device(arrays))

        return fn

    def sample_specs(self) -> List[Tuple[tuple, np.dtype]]:
        """Per-sample input specs ``[(shape without the batch axis,
        dtype)]``."""
        if self._sample_specs_list is None:
            raise RuntimeError(
                "per-sample input specs unavailable: the model was built "
                "without an input_spec, or a non-batch dim is dynamic — "
                "serving needs concrete per-sample shapes")
        return list(self._sample_specs_list)


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


def create_predictor_from_path(model_prefix: str,
                               cipher_key_file: str = "") -> Predictor:
    """A Predictor on the card over the ``.pdexport`` at
    ``model_prefix``."""
    if cipher_key_file:
        raise NotImplementedError(
            "encrypted artifacts need framework/io_crypto.py, which is not "
            "ported yet")
    return Predictor(Config(model_prefix))
