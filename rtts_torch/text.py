"""Text frontend of the port: ``rtts/text`` (pure Python and numpy, no JAX),
shared rather than copied; every module of ``rtts_torch`` and
``chip_smoke.py`` reaches it through here."""

from rtts.text import encode_batch, frontend_vocab_size

__all__ = ["encode_batch", "frontend_vocab_size"]
