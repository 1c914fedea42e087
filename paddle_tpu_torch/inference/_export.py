"""The ``.pdexport`` serving artifact — counterpart of
``paddle_tpu.inference._export``, the single writer and reader of the
format (``jit.save(..., input_spec=...)`` and
``static.save_inference_model`` write it, ``inference.Predictor`` reads
it).

The reference's artifact is a ``jax.export`` serialization; the port's is
a ``torch.export`` ``ExportedProgram`` (``torch.export.save`` bytes), its
weights stored beside the graph. A ``None`` or ``-1`` in an input's shape
becomes a ``torch.export.Dim``, so the program takes any size there (the
variable batch of ``save_inference_model``). ``torch.export`` fixes sizes
0 and 1 to the trace, so dynamic dims are traced at 2 and declared from 1.

The kernels on the serving path (``paddle_tpu_torch::layer_norm_fwd`` and
``paddle_tpu_torch::flash_attn_fwd``, the LayerNorm and causal flash
forwards) are registered ops, which the LayerNorm and flash Functions call
while an export traces them: the exported graph holds them as nodes and
the loaded program calls them, so it launches the kernels on the card.
The artifact lists them (``kernel_nodes``) for the caller to check.

Beside the program the artifact stores the input names, the output names
(one per output: the arity), the input specs and the dtype the weights
were baked in.
"""
from __future__ import annotations

import inspect
import io
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# importing the kernels' modules registers their ops, which loading an
# exported program needs
from ..ops import flash_tpu, fused  # noqa: F401

__all__ = ["make_inputs", "export_module", "write_pdexport", "read_pdexport",
           "kernel_nodes"]

# the size a dynamic dim is traced at (0 and 1 would be specialized)
_TRACE_SIZE = 2


def _dynamic(d) -> bool:
    return d is None or (isinstance(d, int) and d < 0)


def make_inputs(shapes_dtypes: Sequence[Tuple[Sequence, torch.dtype]],
                device) -> Tuple[List[torch.Tensor], List[Optional[dict]]]:
    """Example inputs (zeros, dynamic dims at the trace size) and the
    ``dynamic_shapes`` of ``torch.export.export``: one ``Dim`` per
    dynamic dim, ``d0``, ``d1``, ... in order."""
    inputs, dynamic, k = [], [], 0
    for shape, dtype in shapes_dtypes:
        dims, spec = [], {}
        for axis, d in enumerate(shape):
            if _dynamic(d):
                spec[axis] = torch.export.Dim(f"d{k}", min=1)
                k += 1
                dims.append(_TRACE_SIZE)
            else:
                dims.append(int(d))
        inputs.append(torch.zeros(dims, dtype=dtype, device=device))
        dynamic.append(spec or None)
    return inputs, dynamic


def kernel_nodes(ep) -> Dict[str, int]:
    """The registered kernel ops in an exported graph, by op name."""
    out: Dict[str, int] = {}
    for node in ep.graph.nodes:
        name = str(node.target) if node.op == "call_function" else ""
        if name.startswith("paddle_tpu_torch."):
            op = name.split(".")[1]
            out[op] = out.get(op, 0) + 1
    return out


def export_module(module: torch.nn.Module,
                  shapes_dtypes: Sequence[Tuple[Sequence, torch.dtype]],
                  device):
    """``torch.export`` of ``module`` (in eval mode, without gradients)
    over inputs of the given shapes (None/-1: dynamic) and dtypes on
    ``device`` (non-strict: the Functions see the fake tensors and call
    the registered ops)."""
    inputs, dynamic = make_inputs(shapes_dtypes, device)
    dynamic = tuple(dynamic)
    params = list(inspect.signature(module.forward).parameters.values())
    if params and params[0].kind is inspect.Parameter.VAR_POSITIONAL:
        dynamic = (dynamic,)  # forward(*xs): the specs of the one tuple
    with torch.no_grad():
        return torch.export.export(module, tuple(inputs),
                                   dynamic_shapes=dynamic, strict=False)


def write_pdexport(path_prefix: str, ep, input_names: List[str],
                   output_names: List[str], in_specs: List[Tuple[list, str]],
                   dtype: str = "float32") -> dict:
    """``path_prefix.pdexport``: the program's ``torch.export.save`` bytes
    and the metadata; returns the metadata written."""
    d = os.path.dirname(path_prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    blob = {"format": "torch.export", "program": buf.getvalue(),
            "input_names": list(input_names),
            "output_names": list(output_names),
            "in_specs": [(list(s), str(t)) for s, t in in_specs],
            "kernel_ops": kernel_nodes(ep), "dtype": dtype}
    with open(path_prefix + ".pdexport", "wb") as f:
        pickle.dump(blob, f)
    return {k: v for k, v in blob.items() if k != "program"}


def read_pdexport(path: str):
    """``(ExportedProgram, metadata)`` of a ``.pdexport`` file."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if not isinstance(blob, dict) or blob.get("format") != "torch.export":
        raise ValueError(
            f"{path} is not a torch.export artifact (a .pdexport written by "
            "paddle_tpu's jit.save holds a jax.export program, which this "
            "package cannot load)")
    ep = torch.export.load(io.BytesIO(blob["program"]))
    return ep, {k: v for k, v in blob.items() if k != "program"}
