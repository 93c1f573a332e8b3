"""Data pipeline: packing (the serving engine's part so far)."""
from .packing import first_fit_pack

__all__ = ["first_fit_pack"]
