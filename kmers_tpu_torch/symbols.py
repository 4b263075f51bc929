"""The port's error type for bytes that cannot be encoded.

Counterpart of ``kmers_tpu/symbols.py::EncodeError`` (the port keeps its
own copy and imports nothing of the JAX package).
"""

from __future__ import annotations

__all__ = ["EncodeError"]


class EncodeError(ValueError):
    """Raised when a byte cannot be encoded in an alphabet: an invalid
    byte, or an ambiguous base where ambiguity is not skipped."""

    def __init__(self, alphabet: str, value):
        self.alphabet = alphabet
        self.value = value
        super().__init__(f"cannot encode {value!r} in {alphabet}")
