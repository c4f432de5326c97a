"""Preprocessing: wavs and transcripts -> clips and a manifest; a port of
``rtts/data/preprocess.py``.

``preprocess_corpus`` reads ``transcripts.txt`` (``utt|text`` lines over
``wavs/utt.wav``, or timed lines cut out of a long recording, see
``parse_transcript_line``), resamples to the configured rate, trims
silence at both ends (an energy gate), computes the float32 log-mel on
``device`` (the port's ``make_mel_fn``, TF32 off) and writes one
``.rclip`` a clip plus ``manifest.json`` with the JAX package's keys.  As
the JAX package does, it reads, resamples, trims and writes through the
native library (``rtts_torch.data.native_loader``) whenever that builds,
and otherwise in Python (``read_wav``, ``resample_poly``,
``trim_silence``); ``preprocess_corpus`` says which on stderr.
``extract_audio`` is the ffmpeg subprocess of media extraction.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import subprocess
import sys
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from rtts_torch.audio.resample import resample_poly
from rtts_torch.audio.stft import make_mel_fn
from rtts_torch.audio.wav import read_wav
from rtts_torch.config import DatasetConfig
from rtts_torch.data import native_loader
from rtts_torch.text.tokenizer import text_to_ids


def extract_audio(video_path: str, wav_path: str, sample_rate: int = 22050) -> None:
    """Video -> mono wav via ffmpeg subprocess (host-side, offline stage)."""
    cmd = ["ffmpeg", "-y", "-i", video_path, "-ac", "1", "-ar",
           str(sample_rate), str(wav_path)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except FileNotFoundError as e:
        raise RuntimeError(
            "ffmpeg not available — media extraction is an offline stage; "
            "provide wav inputs directly") from e


def trim_silence(audio: np.ndarray, sample_rate: int, threshold_db: float = -40.0,
                 frame_ms: float = 20.0) -> np.ndarray:
    """Energy-gate silence trim at both ends."""
    frame = max(1, int(sample_rate * frame_ms / 1000))
    n_frames = len(audio) // frame
    if n_frames == 0:
        return audio
    x = audio[: n_frames * frame].reshape(n_frames, frame)
    rms_db = 10.0 * np.log10(np.mean(x * x, axis=1) + 1e-10)
    keep = np.nonzero(rms_db > threshold_db)[0]
    if len(keep) == 0:
        return audio
    start, end = keep[0] * frame, (keep[-1] + 1) * frame
    return audio[start:end]


def parse_transcript_line(ln: str) -> Tuple[str, Optional[str],
                                            Optional[float], Optional[float],
                                            str]:
    """One transcript line -> (utt_id, source, start_s, end_s, text).

    Three accepted layouts:
      ``utt|text``                    — pre-cut per-utterance wav
      ``utt|start|end|text``          — cut [start, end) s from recording.wav
      ``utt|source.wav|start|end|text`` — cut from a named long recording
    Timings are seconds (float).  Text containing '|' only survives in the
    last field, which is never split further."""
    parts = ln.split("|")
    if len(parts) < 2:
        raise ValueError(f"malformed transcript line: {ln!r}")
    if len(parts) == 2:
        return parts[0], None, None, None, parts[1]

    def _is_time(s: str) -> bool:
        try:
            float(s)
            return True
        except ValueError:
            return False

    if len(parts) >= 4 and _is_time(parts[1]) and _is_time(parts[2]):
        return (parts[0], None, float(parts[1]), float(parts[2]),
                "|".join(parts[3:]))
    if len(parts) >= 5 and _is_time(parts[2]) and _is_time(parts[3]):
        return (parts[0], parts[1], float(parts[2]), float(parts[3]),
                "|".join(parts[4:]))
    # 2-field layout whose text happens to contain '|'
    return parts[0], None, None, None, "|".join(parts[1:])


def _load_audio(path: pathlib.Path, sample_rate: int,
                use_native: bool) -> np.ndarray:
    if use_native:
        audio, sr = native_loader.wav_read(str(path))
        if sr != sample_rate:
            audio = native_loader.resample(audio, sr, sample_rate)
    else:
        audio, sr = read_wav(path)
        if sr != sample_rate:
            audio = resample_poly(audio, sr, sample_rate)
    return np.asarray(audio, np.float32)


class _SourceCache:
    """Long recordings loaded+resampled once, sliced many times."""

    def __init__(self, base: pathlib.Path, acfg, use_native: bool):
        self.base = base
        self.acfg = acfg
        self.use_native = use_native
        self._cache = {}

    def load(self, name: str) -> np.ndarray:
        if name not in self._cache:
            self._cache[name] = _load_audio(self.base / name,
                                            self.acfg.sample_rate,
                                            self.use_native)
        return self._cache[name]

    def cut(self, name: str, start_s: float, end_s: float) -> np.ndarray:
        audio = self.load(name)
        sr = self.acfg.sample_rate
        lo = max(0, int(round(start_s * sr)))
        hi = min(len(audio), int(round(end_s * sr)))
        if hi <= lo:
            raise ValueError(
                f"empty cut [{start_s}, {end_s})s from {name} "
                f"({len(audio) / sr:.2f}s long)")
        return audio[lo:hi]


@contextlib.contextmanager
def _no_tf32() -> Iterator[None]:
    """float32 matmuls in full precision (the mel's DFT and filterbank)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _tokens(text: str, tcfg) -> np.ndarray:
    if tcfg.level == "phoneme":
        from rtts_torch.text.g2p import text_to_phonemes
        from rtts_torch.text.phonemes import phonemes_to_ids

        return np.asarray(
            phonemes_to_ids(text_to_phonemes(text, tcfg.cleaner)),
            dtype=np.int32)
    return np.asarray(text_to_ids(text, tcfg.cleaner), dtype=np.int32)


def preprocess_corpus(cfg: DatasetConfig, transcripts_path: str,
                      out_dir: Optional[str] = None,
                      default_source: str = "recording.wav",
                      device="cuda") -> str:
    """Transcript lines -> per-clip files (token ids + log-mel + audio) and
    a manifest json, the log-mel computed on ``device``.  Returns the
    manifest's path.

    Lines may reference pre-cut wavs (``utt|text`` -> wavs/utt.wav) or carry
    transcript timings over long recordings (see parse_transcript_line), in
    which case the utterance is cut out of the recording first."""
    acfg = cfg.audio
    base = pathlib.Path(transcripts_path).parent
    out = pathlib.Path(out_dir or (pathlib.Path(cfg.data_dir) / "clips"))
    out.mkdir(parents=True, exist_ok=True)
    mel_fn = make_mel_fn(acfg)
    use_native = native_loader.available()
    print("[data] preprocess_corpus: " + (
        "native wav read, resample, trim and clip writer" if use_native else
        f"Python path (the native library did not build: "
        f"{native_loader.build_error()})"), file=sys.stderr)
    sources = _SourceCache(base, acfg, use_native)
    entries = []
    with open(transcripts_path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    for ln in lines:
        utt_id, source, start_s, end_s, text = parse_transcript_line(ln)
        if start_s is not None:
            audio = sources.cut(source or default_source, start_s, end_s)
        else:
            audio = _load_audio(base / "wavs" / f"{utt_id}.wav",
                                acfg.sample_rate, use_native)
        trim = native_loader.trim_silence if use_native else trim_silence
        audio = trim(audio, acfg.sample_rate)
        # align audio length to hop so mel frames cover it exactly
        n_frames = max(1, len(audio) // acfg.hop_length)
        audio = audio[: n_frames * acfg.hop_length]
        with torch.no_grad(), _no_tf32():
            mel = mel_fn(torch.as_tensor(audio, device=device))
        mel = mel.cpu().numpy().astype(np.float32)[:n_frames]
        tokens = _tokens(text, cfg.text)
        clip_path = out / f"{utt_id}.rclip"
        native_loader.write_clip(str(clip_path), tokens, mel,
                                 audio.astype(np.float32))
        entries.append({
            "utt_id": utt_id,
            "clip": str(clip_path),
            "text": text,
            "n_tokens": int(len(tokens)),
            "n_frames": int(mel.shape[0]),
            "n_samples": int(len(audio)),
        })
    manifest = {
        "sample_rate": acfg.sample_rate,
        "hop_length": acfg.hop_length,
        "n_mels": acfg.n_mels,
        "clips": entries,
    }
    mpath = pathlib.Path(cfg.data_dir) / cfg.manifest
    mpath.parent.mkdir(parents=True, exist_ok=True)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
    return str(mpath)
