from .loss import cross_entropy

__all__ = ["cross_entropy"]
