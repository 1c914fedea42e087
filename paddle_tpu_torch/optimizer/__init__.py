from .optimizer import Adam, Optimizer

__all__ = ["Adam", "Optimizer"]
