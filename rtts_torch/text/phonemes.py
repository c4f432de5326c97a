"""Phoneme-level frontend option (SURVEY.md §3.1 #5: the reference
tokenizes "character or phoneme level").

ARPAbet symbol inventory (39 CMU phones, vowels carrying 0/1/2 stress
marks) plus punctuation/pause symbols, sharing the pad/eos/unk convention
with the character table.  Input is pre-phonemized text — space-separated
ARPAbet tokens with optional punctuation, e.g. ``"HH AH0 L OW1 ."`` —
the standard interchange format of CMUdict-based pipelines.  (A built-in
grapheme-to-phoneme converter needs a pronunciation lexicon, which this
offline environment cannot ship; plugging an external G2P in front of
``phonemes_to_ids`` is the supported path.)
"""

from __future__ import annotations

from typing import List, Sequence

_VOWELS = ["AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH",
           "IY", "OW", "OY", "UH", "UW"]
_CONSONANTS = ["B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M",
               "N", "NG", "P", "R", "S", "SH", "T", "TH", "V", "W", "Y",
               "Z", "ZH"]
_PUNCT = [" ", ",", ".", "?", "!", ";", ":", "-"]

PAD = "<pad>"
EOS = "<eos>"
UNK = "<unk>"

PHONEME_SYMBOLS: List[str] = (
    [PAD, EOS, UNK]
    + _PUNCT
    + _CONSONANTS
    + [f"{v}{s}" for v in _VOWELS for s in ("0", "1", "2")]
)

PAD_ID, EOS_ID, UNK_ID = 0, 1, 2
_TO_ID = {s: i for i, s in enumerate(PHONEME_SYMBOLS)}
_TO_SYM = {i: s for i, s in enumerate(PHONEME_SYMBOLS)}


def phoneme_vocab_size() -> int:
    return len(PHONEME_SYMBOLS)


def phonemes_to_ids(text: str, append_eos: bool = True) -> List[int]:
    """Space-separated ARPAbet tokens -> ids.  Punctuation may appear as
    its own token; word boundaries are single spaces between word groups
    (written as the ``  `` double-space or explicit punctuation)."""
    ids: List[int] = []
    for tok in text.strip().split():
        if tok in _TO_ID:
            ids.append(_TO_ID[tok])
        elif tok.upper() in _TO_ID:
            ids.append(_TO_ID[tok.upper()])
        else:
            ids.append(UNK_ID)
        ids.append(_TO_ID[" "])
    if ids:
        ids.pop()  # trailing separator
    if append_eos:
        ids.append(EOS_ID)
    return ids


def ids_to_phonemes(ids: Sequence[int]) -> str:
    out = []
    for i in ids:
        i = int(i)
        if i in (PAD_ID, EOS_ID):
            continue
        out.append(_TO_SYM.get(i, UNK))
    return " ".join(s for s in out if s != " ")
