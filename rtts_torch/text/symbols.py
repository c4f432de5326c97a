"""Fixed symbol table for the character-level text frontend.

Capability parity: the reference tokenizes normalized text to a fixed symbol
set with pad/eos handling (SURVEY.md §3.1 #5).  We use a character-level
inventory (letters, digits, punctuation) with reserved pad/eos/unk ids, which
is the Transformer-TTS-lineage convention.
"""

from __future__ import annotations

PAD = "<pad>"
EOS = "<eos>"
UNK = "<unk>"

_PUNCTUATION = list("!'\"(),-.:;? ")
_LETTERS = list("abcdefghijklmnopqrstuvwxyz")
_LETTERS_UPPER = list("ABCDEFGHIJKLMNOPQRSTUVWXYZ")
_DIGITS = list("0123456789")

SYMBOLS: list[str] = [PAD, EOS, UNK] + _PUNCTUATION + _LETTERS + _LETTERS_UPPER + _DIGITS

PAD_ID = 0
EOS_ID = 1
UNK_ID = 2

_SYMBOL_TO_ID = {s: i for i, s in enumerate(SYMBOLS)}
_ID_TO_SYMBOL = {i: s for i, s in enumerate(SYMBOLS)}

assert _SYMBOL_TO_ID[PAD] == PAD_ID
assert _SYMBOL_TO_ID[EOS] == EOS_ID
assert _SYMBOL_TO_ID[UNK] == UNK_ID


def symbol_to_id(s: str) -> int:
    return _SYMBOL_TO_ID.get(s, UNK_ID)


def id_to_symbol(i: int) -> str:
    return _ID_TO_SYMBOL.get(i, UNK)


def vocab_size() -> int:
    return len(SYMBOLS)
