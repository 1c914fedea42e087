from .functionalize import (functionalize, get_buffers, get_params,
                            load_jax_params, set_buffers, set_params)

__all__ = ["functionalize", "get_params", "get_buffers", "load_jax_params",
           "set_params", "set_buffers"]
