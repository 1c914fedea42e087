from . import dtype, enforce, flags, monitor, place, rng, tensor
from .dtype import (bfloat16, bool_, complex64, complex128, convert_dtype,
                    float16, float32, float64, get_default_dtype, int8, int16,
                    int32, int64, set_default_dtype, uint8)
from .enforce import *  # noqa: F401,F403
from .flags import get_flags, set_flags
from .place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, NPUPlace, Place,
                    XPUPlace, get_device, is_compiled_with_cuda,
                    is_compiled_with_tpu, resolve_device, set_device)
from .rng import get_rng_state_tracker, seed
from .tensor import (Parameter, Tensor, enable_grad, is_grad_enabled,
                     no_grad, set_grad_enabled, to_tensor)

__all__ = ["resolve_device", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace",
           "NPUPlace", "XPUPlace", "Place", "set_device", "get_device",
           "is_compiled_with_cuda", "is_compiled_with_tpu", "convert_dtype",
           "get_default_dtype", "set_default_dtype", "get_flags",
           "set_flags", "seed", "get_rng_state_tracker", "to_tensor",
           "Tensor", "Parameter", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled"]
