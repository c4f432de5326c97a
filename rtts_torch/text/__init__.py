"""Text frontend of the port: a copy of ``rtts/text`` (symbol table, cleaners,
phonemes, offline G2P, tokenizer), so the port imports nothing of the JAX
package.  The two must tokenize alike: ``tests/test_torch_copies.py`` holds
``encode_batch`` of both equal."""

from rtts_torch.text.symbols import SYMBOLS, PAD_ID, EOS_ID, symbol_to_id, vocab_size
from rtts_torch.text.cleaners import clean_text
from rtts_torch.text.tokenizer import text_to_ids, ids_to_text, encode_batch, token_lengths
from rtts_torch.text.phonemes import (
    PHONEME_SYMBOLS,
    phoneme_vocab_size,
    phonemes_to_ids,
    ids_to_phonemes,
)


def frontend_vocab_size(level: str = "char") -> int:
    """Vocab size for the configured tokenization level."""
    return phoneme_vocab_size() if level == "phoneme" else vocab_size()

__all__ = [
    "SYMBOLS",
    "PAD_ID",
    "EOS_ID",
    "symbol_to_id",
    "vocab_size",
    "clean_text",
    "text_to_ids",
    "ids_to_text",
    "encode_batch",
    "token_lengths",
    "PHONEME_SYMBOLS",
    "phoneme_vocab_size",
    "phonemes_to_ids",
    "ids_to_phonemes",
    "frontend_vocab_size",
]
