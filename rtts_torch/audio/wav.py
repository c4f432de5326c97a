"""Host-side wav read/write: a copy of ``rtts/audio/wav.py``.

The stdlib ``wave`` module with 16-bit PCM and float32 conversion; the
port keeps its own copy because it imports nothing of the JAX package
(``tests/test_torch_copies.py`` holds the two equal).
"""

from __future__ import annotations

import pathlib
import wave
from typing import Tuple, Union

import numpy as np


def read_wav(path: Union[str, pathlib.Path]) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (float32 mono samples in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if n_ch > 1:
        data = data.reshape(-1, n_ch).mean(axis=1)
    return data, sr


def write_wav(path: Union[str, pathlib.Path], data: np.ndarray, sample_rate: int) -> None:
    """Write float32 samples in [-1, 1] as 16-bit PCM wav."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pcm = np.clip(np.asarray(data, dtype=np.float32), -1.0, 1.0)
    pcm = np.round(pcm * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
