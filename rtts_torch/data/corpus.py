"""The synthetic speech-like corpus: a copy of ``rtts/data/corpus.py``.

Formant-style harmonic "utterances" whose acoustics follow the text
(vowels get formant stacks, consonants noise bursts, spaces and punctuation
silence), so text -> mel is learnable; ``generate_corpus`` writes
``wavs/utt*.wav`` and ``transcripts.txt``, ``generate_long_recording`` one
long wav and a timed transcript.  Both packages write the same bytes
(``tests/test_torch_pipeline.py``).  Numpy and the port's wav writer and
cleaners only; no torch.
"""

from __future__ import annotations

import hashlib
import pathlib
from dataclasses import dataclass
from typing import List

import numpy as np

from rtts_torch.audio.wav import write_wav
from rtts_torch.text.cleaners import clean_text

_SENTENCES = [
    "the quick brown fox jumps over the lazy dog.",
    "she sells sea shells by the sea shore.",
    "a stitch in time saves nine.",
    "all that glitters is not gold.",
    "actions speak louder than words.",
    "the early bird catches the worm.",
    "practice makes perfect every day.",
    "better late than never they say.",
    "birds of a feather flock together.",
    "every cloud has a silver lining.",
    "fortune favors the bold and brave.",
    "honesty is the best policy always.",
    "knowledge is power, use it wisely.",
    "look before you leap my friend.",
    "no pain no gain in this life.",
    "curiosity killed the cat, satisfaction brought it back.",
    "rome was not built in a day.",
    "slow and steady wins the race.",
    "the pen is mightier than the sword.",
    "when in rome do as the romans do.",
    "two wrongs do not make a right.",
    "the grass is always greener on the other side.",
    "do not count your chickens before they hatch.",
    "a picture is worth a thousand words.",
]

# Word banks for the procedural sentence composer (`sentence_for_index`
# below): utterance indices past the curated ``_SENTENCES`` pool draw a
# deterministic subject/verb/object/tail sentence, so an "enlarged" corpus
# (hundreds of utterances for convergence runs) has unique text per clip
# instead of cycling 24 sentences.
_SUBJECTS = [
    "the quick fox", "a wise old owl", "the river", "my neighbor",
    "the young painter", "a distant train", "the tall lighthouse",
    "our patient teacher", "the winter wind", "a curious child",
    "the silver moon", "the old clock", "a gentle rain", "the busy market",
    "the quiet library", "a brave sailor", "the mountain road",
    "the evening choir", "a small boat", "the garden gate",
]
_VERBS = [
    "follows", "remembers", "watches", "welcomes", "crosses", "discovers",
    "carries", "repeats", "measures", "answers", "borrows", "gathers",
    "reaches", "teaches", "forgives", "surprises", "awaits", "describes",
    "observes", "repairs",
]
_OBJECTS = [
    "the narrow path", "an open door", "the morning light", "a secret song",
    "the last letter", "a golden leaf", "the broken bridge",
    "an honest answer", "the hidden valley", "a warm fire",
    "the silent harbor", "a forgotten name", "the rising tide",
    "an early spring", "the wooden table", "a steady rhythm",
    "the northern star", "a simple meal", "the village square",
    "an ancient map",
]
_TAILS = [
    "before the storm arrives", "after the long journey",
    "beyond the green hills", "under the pale sky", "without a single word",
    "near the frozen lake", "during the quiet night", "beside the old mill",
    "along the dusty road", "against the falling snow",
    "within the walled garden", "despite the heavy fog",
    "through the open window", "between the tall pines",
    "behind the stone wall", "over the shallow stream",
]


def sentence_for_index(i: int) -> str:
    """Deterministic text for utterance ``i``: the curated pool first, then
    composed subject-verb-object-tail sentences (unique through tens of
    thousands of indices)."""
    if i < len(_SENTENCES):
        return _SENTENCES[i]
    rng = np.random.default_rng(0xC0DE + i)
    parts = [
        _SUBJECTS[rng.integers(len(_SUBJECTS))],
        _VERBS[rng.integers(len(_VERBS))],
        _OBJECTS[rng.integers(len(_OBJECTS))],
        _TAILS[rng.integers(len(_TAILS))],
    ]
    sep = "," if rng.random() < 0.3 else ""
    return f"{parts[0]} {parts[1]} {parts[2]}{sep} {parts[3]}."


_VOWELS = {
    "a": (730, 1090, 2440),
    "e": (530, 1840, 2480),
    "i": (270, 2290, 3010),
    "o": (570, 840, 2410),
    "u": (300, 870, 2240),
    "y": (300, 2200, 2900),
}


@dataclass
class Utterance:
    utt_id: str
    text: str
    wav_path: str
    duration_s: float


def synth_utterance(text: str, sample_rate: int = 22050,
                    char_dur_s: float = 0.08, f0: float = 120.0) -> np.ndarray:
    """Deterministic text -> waveform: each character maps to a short
    acoustic segment (formants for vowels, noise for consonants, silence
    for spaces/punctuation)."""
    seg_len = int(char_dur_s * sample_rate)
    rng = np.random.default_rng(
        int.from_bytes(hashlib.md5(text.encode()).digest()[:4], "little"))
    pieces: List[np.ndarray] = []
    t = np.arange(seg_len) / sample_rate
    phase = 0.0
    for ch in text.lower():
        if ch in _VOWELS:
            f1, f2, f3 = _VOWELS[ch]
            seg = np.zeros(seg_len)
            # harmonic stack shaped by formant resonances
            for h in range(1, 30):
                fh = f0 * h
                if fh > sample_rate / 2 - 200:
                    break
                amp = sum(np.exp(-0.5 * ((fh - fc) / 220.0) ** 2)
                          for fc in (f1, f2, f3))
                seg += amp * np.sin(2 * np.pi * fh * t + phase * h)
            seg *= 0.25 / (np.abs(seg).max() + 1e-9)
            phase += 2 * np.pi * f0 * char_dur_s
        elif ch.isalpha():
            # consonant: band-filtered noise burst, band from char identity
            lo = 1000 + (ord(ch) % 13) * 400
            noise = rng.standard_normal(seg_len)
            spec = np.fft.rfft(noise)
            freqs = np.fft.rfftfreq(seg_len, 1 / sample_rate)
            band = np.exp(-0.5 * ((freqs - lo) / 600.0) ** 2)
            seg = np.fft.irfft(spec * band, n=seg_len)
            seg *= 0.15 / (np.abs(seg).max() + 1e-9)
        else:
            seg = np.zeros(seg_len)
        # short fade to avoid clicks
        fade = min(64, seg_len // 4)
        env = np.ones(seg_len)
        env[:fade] = np.linspace(0, 1, fade)
        env[-fade:] = np.linspace(1, 0, fade)
        pieces.append(seg * env)
    return np.concatenate(pieces).astype(np.float32)


def generate_long_recording(out_dir: str | pathlib.Path,
                            n_utterances: int = 8,
                            sample_rate: int = 22050,
                            gap_s: float = 0.35) -> str:
    """One LONG wav of utterances separated by silence + a TIMED transcript
    (``utt|start|end|text`` lines) — the fixture for the reference's
    "slice audio by transcript timing" preprocessing stage.
    Returns the transcript path."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    gap = np.zeros(int(gap_s * sample_rate), np.float32)
    pieces: List[np.ndarray] = [gap]
    lines = []
    t = len(gap) / sample_rate
    for i in range(n_utterances):
        text = sentence_for_index(i)
        audio = synth_utterance(clean_text(text), sample_rate)
        start, end = t, t + len(audio) / sample_rate
        lines.append(f"long{i:04d}|{start:.3f}|{end:.3f}|{text}")
        pieces.append(audio)
        pieces.append(gap)
        t = end + gap_s
    write_wav(out / "recording.wav", np.concatenate(pieces), sample_rate)
    tpath = out / "transcripts_timed.txt"
    with open(tpath, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(tpath)


def generate_corpus(out_dir: str | pathlib.Path, n_utterances: int = 24,
                    sample_rate: int = 22050) -> List[Utterance]:
    """Write wav files + transcript list; returns utterance records."""
    out = pathlib.Path(out_dir)
    wav_dir = out / "wavs"
    wav_dir.mkdir(parents=True, exist_ok=True)
    utts = []
    for i in range(n_utterances):
        text = sentence_for_index(i)
        cleaned = clean_text(text)
        audio = synth_utterance(cleaned, sample_rate)
        utt_id = f"utt{i:04d}"
        path = wav_dir / f"{utt_id}.wav"
        write_wav(path, audio, sample_rate)
        utts.append(Utterance(utt_id, text, str(path),
                              len(audio) / sample_rate))
    with open(out / "transcripts.txt", "w") as f:
        for u in utts:
            f.write(f"{u.utt_id}|{u.text}\n")
    return utts
