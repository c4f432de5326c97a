"""Text normalization/cleaning pipeline.

Capability parity: the reference runs tacotron-lineage cleaner functions
(lowercase, abbreviation expansion, number spelling, whitespace collapse)
before tokenization (SURVEY.md §3.1 #5).  Implemented from scratch — pure
Python string processing, host-side (tokenization is offline/pre-jit).
"""

from __future__ import annotations

import re
import unicodedata

_WHITESPACE_RE = re.compile(r"\s+")

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALE = [(10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand")]


def _spell_int(n: int) -> str:
    if n < 0:
        return "minus " + _spell_int(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + (" " + _ONES[rem] if rem else "")
    if n < 1000:
        hundreds, rem = divmod(n, 100)
        return _ONES[hundreds] + " hundred" + (" " + _spell_int(rem) if rem else "")
    for scale, name in _SCALE:
        if n >= scale:
            major, rem = divmod(n, scale)
            return _spell_int(major) + f" {name}" + (" " + _spell_int(rem) if rem else "")
    return str(n)  # pragma: no cover — unreachable below 1e12


_NUMBER_RE = re.compile(r"\d+")
_DECIMAL_RE = re.compile(r"(\d+)\.(\d+)")
_COMMA_NUMBER_RE = re.compile(r"(\d),(\d)")


def expand_numbers(text: str) -> str:
    text = _COMMA_NUMBER_RE.sub(r"\1\2", text)
    text = _DECIMAL_RE.sub(
        lambda m: _spell_int(int(m.group(1)))
        + " point "
        + " ".join(_ONES[int(d)] for d in m.group(2)),
        text,
    )
    return _NUMBER_RE.sub(lambda m: _spell_int(int(m.group(0))), text)


def expand_abbreviations(text: str) -> str:
    for pattern, replacement in _ABBREVIATIONS:
        text = pattern.sub(replacement, text)
    return text


def to_ascii(text: str) -> str:
    return unicodedata.normalize("NFKD", text).encode("ascii", "ignore").decode()


def collapse_whitespace(text: str) -> str:
    return _WHITESPACE_RE.sub(" ", text).strip()


def basic_cleaner(text: str) -> str:
    return collapse_whitespace(text.lower())


def english_cleaner(text: str) -> str:
    text = to_ascii(text)
    text = text.lower()
    text = expand_abbreviations(text)
    text = expand_numbers(text)
    return collapse_whitespace(text)


_CLEANERS = {
    "identity": lambda t: t,
    "basic": basic_cleaner,
    "english": english_cleaner,
}


def clean_text(text: str, cleaner: str = "english") -> str:
    try:
        fn = _CLEANERS[cleaner]
    except KeyError:
        raise ValueError(f"unknown cleaner {cleaner!r}; options: {sorted(_CLEANERS)}")
    return fn(text)
