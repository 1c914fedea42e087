from .functionalize import functionalize, get_params, load_jax_params, set_params

__all__ = ["functionalize", "get_params", "load_jax_params", "set_params"]
