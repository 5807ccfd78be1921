"""The typed errors of the port's entry points: the port's own copy of
the part of ``paddle_tpu/utils/enforce.py`` it raises, with the same
class hierarchy, so callers catch the same types in both packages."""
from __future__ import annotations

from typing import Optional

__all__ = ["EnforceNotMet", "OutOfRangeError"]


class EnforceNotMet(RuntimeError):
    """Root of the error hierarchy; ``hint`` says how to fix the call."""

    def __init__(self, message: str, hint: Optional[str] = None):
        self.hint = hint
        self._formatted = message if hint is None \
            else f"{message}\n  [Hint: {hint}]"
        super().__init__(self._formatted)

    def __str__(self):
        return self._formatted


class OutOfRangeError(EnforceNotMet, IndexError, ValueError):
    """A value past its range (also a ValueError, as in the JAX
    package)."""
