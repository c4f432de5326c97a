"""Character tokenizer producing static-shape, chunk-aligned id arrays.

TPU-first design note: downstream LSH attention requires sequence lengths
that are multiples of the chunk length (reference autopads at eval and
requires multiples at train — SURVEY.md §3.2 "Input autopadding").  We bake
that in here: ``encode_batch`` pads every sequence (after appending EOS) to a
multiple of ``pad_to_multiple`` and returns an explicit boolean mask, so
everything entering jit has a static, aligned shape.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from rtts_torch.text.cleaners import clean_text
from rtts_torch.text.symbols import EOS_ID, PAD_ID, id_to_symbol, symbol_to_id


def text_to_ids(text: str, cleaner: str = "english", append_eos: bool = True) -> List[int]:
    cleaned = clean_text(text, cleaner)
    ids = [symbol_to_id(ch) for ch in cleaned]
    if append_eos:
        ids.append(EOS_ID)
    return ids


def ids_to_text(ids: Sequence[int]) -> str:
    out = []
    for i in ids:
        i = int(i)
        if i in (PAD_ID, EOS_ID):
            continue
        out.append(id_to_symbol(i))
    return "".join(out)


def _round_up(n: int, multiple: int) -> int:
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


def token_lengths(texts: Sequence[str], cleaner: str = "english",
                  level: str = "char") -> List[int]:
    """Unpadded (text+eos) token counts — the serving length predictor's
    input (Synthesizer.serve buckets requests by these)."""
    if level == "phoneme":
        from rtts_torch.text.g2p import text_to_phonemes
        from rtts_torch.text.phonemes import phonemes_to_ids

        return [len(phonemes_to_ids(text_to_phonemes(t, cleaner)))
                for t in texts]
    return [len(text_to_ids(t, cleaner)) for t in texts]


def encode_batch(
    texts: Sequence[str],
    cleaner: str = "english",
    pad_to_multiple: int = 64,
    max_len: Optional[int] = None,
    level: str = "char",
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode a batch of strings to (ids, mask) int32/bool arrays.

    level="char": cleaned characters; level="phoneme": space-separated
    ARPAbet tokens (see rtts_torch.text.phonemes).  All rows are padded to one
    common length: the longest (text+eos) length rounded up to
    ``pad_to_multiple`` (and clamped to ``max_len`` if given, which must
    itself be a multiple)."""
    if level == "phoneme":
        from rtts_torch.text.g2p import text_to_phonemes
        from rtts_torch.text.phonemes import phonemes_to_ids

        # raw text is phonemized by the built-in offline G2P (lexicon +
        # letter-to-sound); already-ARPAbet input passes through unchanged
        seqs = [phonemes_to_ids(text_to_phonemes(t, cleaner)) for t in texts]
    else:
        seqs = [text_to_ids(t, cleaner) for t in texts]
    longest = max(len(s) for s in seqs)
    target = _round_up(longest, pad_to_multiple)
    if max_len is not None:
        if max_len % max(pad_to_multiple, 1) != 0:
            raise ValueError(f"max_len={max_len} not a multiple of {pad_to_multiple}")
        target = min(target, max_len)
    ids = np.full((len(seqs), target), PAD_ID, dtype=np.int32)
    mask = np.zeros((len(seqs), target), dtype=bool)
    for r, s in enumerate(seqs):
        s = s[:target]
        if len(s) == target and s[-1] != EOS_ID:
            s = s[:-1] + [EOS_ID]  # keep EOS when truncating
        ids[r, : len(s)] = s
        mask[r, : len(s)] = True
    return ids, mask
