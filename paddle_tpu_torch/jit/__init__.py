from .functionalize import get_params, load_jax_params

__all__ = ["get_params", "load_jax_params"]
