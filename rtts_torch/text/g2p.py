"""Offline grapheme-to-phoneme (G2P): abridged built-in lexicon + a
deterministic letter-to-sound fallback (SURVEY.md §3.1 #5 — makes
``text.level=phoneme`` usable on RAW text end-to-end with no network).

The lexicon is a small CMUdict-style table (most-frequent English words +
the in-repo synthetic corpus vocabulary).  Out-of-vocabulary words go
through ``letter_to_sound`` — ordered digraph/trigraph rules then
per-letter defaults; crude but fully deterministic, so tokenization is
reproducible across runs and machines.  For production lexicons, feed
pre-phonemized ARPAbet (rtts_torch.text.phonemes) — ``text_to_phonemes`` detects
already-phonemized input and passes it through unchanged.
"""

from __future__ import annotations

import re
from typing import List

from rtts_torch.text.cleaners import clean_text
from rtts_torch.text.phonemes import PHONEME_SYMBOLS

# Abridged CMUdict-style lexicon (ARPAbet with stress digits).
LEXICON = {
    "a": "AH0", "about": "AH0 B AW1 T", "above": "AH0 B AH1 V",
    "actions": "AE1 K SH AH0 N Z", "after": "AE1 F T ER0",
    "again": "AH0 G EH1 N", "all": "AO1 L", "also": "AO1 L S OW0",
    "always": "AO1 L W EY2 Z", "an": "AE1 N", "and": "AH0 N D",
    "any": "EH1 N IY0", "are": "AA1 R", "as": "AE1 Z", "at": "AE1 T",
    "back": "B AE1 K", "be": "B IY1", "because": "B IH0 K AO1 Z",
    "been": "B IH1 N", "before": "B IH0 F AO1 R", "best": "B EH1 S T",
    "better": "B EH1 T ER0", "bird": "B ER1 D", "birds": "B ER1 D Z",
    "bold": "B OW1 L D", "brave": "B R EY1 V",
    "brought": "B R AO1 T", "brown": "B R AW1 N", "built": "B IH1 L T",
    "but": "B AH1 T", "by": "B AY1", "can": "K AE1 N",
    "cat": "K AE1 T", "catches": "K AE1 CH IH0 Z",
    "chickens": "CH IH1 K AH0 N Z", "cloud": "K L AW1 D",
    "come": "K AH1 M", "could": "K UH1 D", "count": "K AW1 N T",
    "curiosity": "K Y UH2 R IY0 AA1 S AH0 T IY0",
    "day": "D EY1", "do": "D UW1", "dog": "D AO1 G",
    "down": "D AW1 N", "each": "IY1 CH", "early": "ER1 L IY0",
    "eight": "EY1 T", "every": "EH1 V ER0 IY0",
    "favors": "F EY1 V ER0 Z", "feather": "F EH1 DH ER0",
    "find": "F AY1 N D", "first": "F ER1 S T", "five": "F AY1 V",
    "flock": "F L AA1 K", "for": "F AO1 R",
    "fortune": "F AO1 R CH AH0 N", "four": "F AO1 R",
    "fox": "F AA1 K S", "friend": "F R EH1 N D", "from": "F R AH1 M",
    "gain": "G EY1 N", "get": "G EH1 T",
    "glitters": "G L IH1 T ER0 Z", "go": "G OW1", "gold": "G OW1 L D",
    "good": "G UH1 D", "grass": "G R AE1 S",
    "greener": "G R IY1 N ER0", "had": "HH AE1 D", "has": "HH AE1 Z",
    "hatch": "HH AE1 CH", "have": "HH AE1 V", "he": "HH IY1",
    "hello": "HH AH0 L OW1", "her": "HH ER1", "here": "HH IY1 R",
    "him": "HH IH1 M", "his": "HH IH1 Z",
    "honesty": "AA1 N AH0 S T IY0", "how": "HH AW1", "i": "AY1",
    "if": "IH1 F", "in": "IH0 N", "into": "IH0 N T UW1",
    "is": "IH1 Z", "it": "IH1 T", "its": "IH1 T S",
    "jumps": "JH AH1 M P S", "just": "JH AH1 S T",
    "killed": "K IH1 L D", "know": "N OW1",
    "knowledge": "N AA1 L AH0 JH", "late": "L EY1 T",
    "lazy": "L EY1 Z IY0", "leap": "L IY1 P", "life": "L AY1 F",
    "like": "L AY1 K", "lining": "L AY1 N IH0 NG",
    "little": "L IH1 T AH0 L", "long": "L AO1 NG",
    "look": "L UH1 K", "louder": "L AW1 D ER0", "made": "M EY1 D",
    "make": "M EY1 K", "makes": "M EY1 K S", "many": "M EH1 N IY0",
    "may": "M EY1", "me": "M IY1", "mightier": "M AY1 T IY0 ER0",
    "more": "M AO1 R", "most": "M OW1 S T", "my": "M AY1",
    "never": "N EH1 V ER0", "new": "N UW1", "nine": "N AY1 N",
    "no": "N OW1", "not": "N AA1 T", "now": "N AW1",
    "of": "AH0 V", "off": "AO1 F", "on": "AA1 N", "one": "W AH1 N",
    "only": "OW1 N L IY0", "or": "AO1 R", "other": "AH1 DH ER0",
    "our": "AW1 ER0", "out": "AW1 T", "over": "OW1 V ER0",
    "pain": "P EY1 N", "pen": "P EH1 N",
    "perfect": "P ER1 F IH0 K T", "picture": "P IH1 K CH ER0",
    "policy": "P AA1 L AH0 S IY0", "power": "P AW1 ER0",
    "practice": "P R AE1 K T IH0 S", "quick": "K W IH1 K",
    "race": "R EY1 S", "right": "R AY1 T",
    "romans": "R OW1 M AH0 N Z", "rome": "R OW1 M",
    "said": "S EH1 D", "satisfaction": "S AE2 T AH0 S F AE1 K SH AH0 N",
    "saves": "S EY1 V Z", "say": "S EY1", "sea": "S IY1",
    "see": "S IY1", "sells": "S EH1 L Z", "seven": "S EH1 V AH0 N",
    "she": "SH IY1", "shells": "SH EH1 L Z", "shore": "SH AO1 R",
    "side": "S AY1 D", "silver": "S IH1 L V ER0", "six": "S IH1 K S",
    "slow": "S L OW1", "so": "S OW1", "some": "S AH1 M",
    "speak": "S P IY1 K", "steady": "S T EH1 D IY0",
    "stitch": "S T IH1 CH", "sword": "S AO1 R D",
    "than": "DH AE1 N", "that": "DH AE1 T", "the": "DH AH0",
    "their": "DH EH1 R", "them": "DH EH1 M", "then": "DH EH1 N",
    "there": "DH EH1 R", "these": "DH IY1 Z", "they": "DH EY1",
    "this": "DH IH1 S", "thousand": "TH AW1 Z AH0 N D",
    "three": "TH R IY1", "time": "T AY1 M", "to": "T UW1",
    "together": "T AH0 G EH1 DH ER0", "two": "T UW1",
    "up": "AH1 P", "us": "AH1 S", "use": "Y UW1 Z",
    "very": "V EH1 R IY0", "was": "W AA1 Z", "water": "W AO1 T ER0",
    "way": "W EY1", "we": "W IY1", "well": "W EH1 L",
    "were": "W ER1", "what": "W AH1 T", "when": "W EH1 N",
    "where": "W EH1 R", "which": "W IH1 CH", "who": "HH UW1",
    "will": "W IH1 L", "wins": "W IH1 N Z", "wisely": "W AY1 Z L IY0",
    "with": "W IH1 DH", "words": "W ER1 D Z", "world": "W ER1 L D",
    "worm": "W ER1 M", "worth": "W ER1 TH",
    "would": "W UH1 D", "wrongs": "R AO1 NG Z",
    "year": "Y IH1 R", "you": "Y UW1", "your": "Y AO1 R",
}

# Ordered letter-to-sound rules: longest-match-first grapheme clusters.
_LTS_RULES = [
    ("tion", ["SH", "AH0", "N"]),
    ("igh", ["AY1"]),
    ("ing", ["IH0", "NG"]),
    ("ch", ["CH"]), ("sh", ["SH"]), ("th", ["TH"]), ("ph", ["F"]),
    ("wh", ["W"]), ("ck", ["K"]), ("ng", ["NG"]), ("qu", ["K", "W"]),
    ("ee", ["IY1"]), ("ea", ["IY1"]), ("oo", ["UW1"]), ("ai", ["EY1"]),
    ("ay", ["EY1"]), ("oa", ["OW1"]), ("ow", ["AW1"]), ("ou", ["AW1"]),
    ("oi", ["OY1"]), ("oy", ["OY1"]), ("ar", ["AA1", "R"]),
    ("or", ["AO1", "R"]), ("er", ["ER0"]), ("ir", ["ER1"]),
    ("ur", ["ER1"]),
]
_LTS_SINGLE = {
    "a": ["AE1"], "e": ["EH1"], "i": ["IH1"], "o": ["AA1"], "u": ["AH1"],
    "b": ["B"], "c": ["K"], "d": ["D"], "f": ["F"], "g": ["G"],
    "h": ["HH"], "j": ["JH"], "k": ["K"], "l": ["L"], "m": ["M"],
    "n": ["N"], "p": ["P"], "r": ["R"], "s": ["S"], "t": ["T"],
    "v": ["V"], "w": ["W"], "x": ["K", "S"], "z": ["Z"],
}


def letter_to_sound(word: str) -> List[str]:
    """Deterministic rule-based fallback for out-of-lexicon words."""
    w = word.lower()
    if len(w) > 3 and w.endswith("e") and w[-2] not in "aeiou":
        w = w[:-1]  # final silent e
    phones: List[str] = []
    i = 0
    while i < len(w):
        for graph, ph in _LTS_RULES:
            if w.startswith(graph, i):
                phones.extend(ph)
                i += len(graph)
                break
        else:
            ch = w[i]
            if ch == "y":
                phones.append("Y" if i == 0 else "IY0")
            else:
                phones.extend(_LTS_SINGLE.get(ch, []))
            i += 1
    return phones


_PHONE_SET = set(PHONEME_SYMBOLS)
_WORD_RE = re.compile(r"[a-z']+|[,.?!;:\-]")


def looks_phonemized(text: str) -> bool:
    """True when every whitespace token is already a valid ARPAbet symbol
    or punctuation mark (the pre-phonemized interchange format)."""
    toks = text.strip().split()
    return bool(toks) and all(
        t in _PHONE_SET or t.upper() in _PHONE_SET for t in toks)


def text_to_phonemes(text: str, cleaner: str = "english") -> str:
    """Raw text -> space-separated ARPAbet token string (lexicon first,
    letter-to-sound fallback); already-phonemized input passes through."""
    if looks_phonemized(text):
        return text
    cleaned = clean_text(text, cleaner)
    out: List[str] = []
    for tok in _WORD_RE.findall(cleaned.lower()):
        if tok in ",.?!;:-":
            out.append(tok)
        else:
            pron = LEXICON.get(tok.strip("'"))
            out.extend(pron.split() if pron else letter_to_sound(tok))
    return " ".join(out)
