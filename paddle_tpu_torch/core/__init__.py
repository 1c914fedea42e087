from .place import CPUPlace, CUDAPlace, resolve_device

__all__ = ["resolve_device", "CPUPlace", "CUDAPlace"]
