"""ctypes bindings and the lazy g++ build of the port's native clip loader
and audio DSP (``rtts_torch/csrc/rtts_native.cc``); a port of
``rtts/data/native_loader.py`` with its names and signatures.

The library is host code: g++ (``-O2 -std=c++17 -shared -fPIC -pthread``)
builds it at first use into ``build/rtts_torch/`` at the root of the
checkout, under a name that carries a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.  A
failed build is not hidden: ``available()`` is False, ``build_error()``
holds g++'s message, and the datasets say which path they took and why
(``rtts_torch.data.dataset``).  Everything returns numpy arrays.

- ``NativeClipLoader``: a C++ thread pool that reads ``.rclip`` files into
  an LRU cache, ``prefetch``es clips ahead of use and collates padded TTS
  batches (``fill_batch``) and vocoder crops (``fill_crops``) into numpy
  buffers off the Python thread.
- ``wav_read``, ``resample`` (polyphase windowed sinc), ``trim_silence``
  (an energy gate) and ``write_clip``: preprocessing's native branch.
- ``read_clip`` and ``write_clip``'s Python branch: the ``.rclip`` format
  in Python, byte for byte the library's.

``calls`` counts each entry's calls that ran through the library (an
entry that raises, or ``write_clip`` writing in Python, counts none): a
caller sets it to zero and reads it to see that a run took the native path.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import struct
import subprocess
import tempfile
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_HERE = pathlib.Path(__file__).resolve()
SRC = _HERE.parents[1] / "csrc" / "rtts_native.cc"
BUILD_DIR = _HERE.parents[2] / "build" / "rtts_torch"
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

calls: collections.Counter = collections.Counter()

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"librtts_native_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library unless one built from this source exists;
    raises RuntimeError with g++'s message when it cannot."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native clip loader "
                           "cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # built under a private name and renamed into place: a concurrent
    # loader never sees a half-written library
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True, timeout=180)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {SRC}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None (the reason in
    ``build_error()``) when it cannot be built or loaded.  A failure is
    remembered: g++ runs at most once a process."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
            _build_error = f"{type(e).__name__}: {e}"
            return None
        c = ctypes
        lib.rtts_loader_create.restype = c.c_void_p
        lib.rtts_loader_create.argtypes = [c.POINTER(c.c_char_p), c.c_int,
                                           c.c_int, c.c_int64]
        lib.rtts_loader_destroy.argtypes = [c.c_void_p]
        lib.rtts_loader_prefetch.argtypes = [c.c_void_p,
                                             c.POINTER(c.c_int), c.c_int]
        lib.rtts_loader_fill_batch.restype = c.c_int
        lib.rtts_loader_fill_batch.argtypes = [
            c.c_void_p, c.POINTER(c.c_int), c.c_int, c.c_int, c.c_int,
            c.c_int, c.POINTER(c.c_int32), c.POINTER(c.c_uint8),
            c.POINTER(c.c_float), c.POINTER(c.c_uint8)]
        lib.rtts_loader_fill_crops.restype = c.c_int
        lib.rtts_loader_fill_crops.argtypes = [
            c.c_void_p, c.POINTER(c.c_int), c.POINTER(c.c_int), c.c_int,
            c.c_int, c.c_int, c.c_int, c.POINTER(c.c_float),
            c.POINTER(c.c_float)]
        lib.rtts_wav_read_pcm16.restype = c.c_int64
        lib.rtts_wav_read_pcm16.argtypes = [c.c_char_p,
                                            c.POINTER(c.POINTER(c.c_float)),
                                            c.POINTER(c.c_int)]
        lib.rtts_free.argtypes = [c.c_void_p]
        lib.rtts_resample.restype = c.c_int64
        lib.rtts_resample.argtypes = [c.POINTER(c.c_float), c.c_int64,
                                      c.c_int, c.c_int,
                                      c.POINTER(c.POINTER(c.c_float))]
        lib.rtts_trim_silence.argtypes = [
            c.POINTER(c.c_float), c.c_int64, c.c_int, c.c_float, c.c_float,
            c.POINTER(c.c_int64), c.POINTER(c.c_int64)]
        lib.rtts_clip_write.restype = c.c_int
        lib.rtts_clip_write.argtypes = [
            c.c_char_p, c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_float), c.c_int, c.c_int,
            c.POINTER(c.c_float), c.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    return _build_error


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {build_error()}")
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def write_clip(path: str, tokens: np.ndarray, mel: np.ndarray,
               audio: np.ndarray) -> None:
    """One ``.rclip`` file: magic, five uint32 sizes (version 1, tokens,
    frames, mels, samples), then int32 tokens, f32 mel frames and f32
    samples; by the library where it is built, else in Python (the same
    bytes)."""
    lib = _load()
    tokens = np.ascontiguousarray(tokens, np.int32)
    mel = np.ascontiguousarray(mel, np.float32)
    audio = np.ascontiguousarray(audio, np.float32)
    if lib is not None:
        rc = lib.rtts_clip_write(
            str(path).encode(),
            tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(tokens), _fptr(mel), mel.shape[0], mel.shape[1],
            _fptr(audio), len(audio))
        if rc == 0:
            calls["write_clip"] += 1
            return
    with open(path, "wb") as f:
        f.write(b"RCLP")
        f.write(struct.pack("<5I", 1, len(tokens), mel.shape[0],
                            mel.shape[1], len(audio)))
        f.write(tokens.tobytes())
        f.write(mel.tobytes())
        f.write(audio.tobytes())


def read_clip(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tokens, mel, audio) of one ``.rclip`` file, in Python."""
    with open(path, "rb") as f:
        if f.read(4) != b"RCLP":
            raise ValueError(f"{path}: not an rclip file")
        ver, n_tokens, n_frames, n_mels, n_samples = struct.unpack(
            "<5I", f.read(20))
        if ver != 1:
            raise ValueError(f"{path}: unsupported rclip version {ver}")
        tokens = np.frombuffer(f.read(4 * n_tokens), np.int32)
        mel = np.frombuffer(f.read(4 * n_frames * n_mels),
                            np.float32).reshape(n_frames, n_mels)
        audio = np.frombuffer(f.read(4 * n_samples), np.float32)
    return tokens, mel, audio


def wav_read(path: str) -> Tuple[np.ndarray, int]:
    """16-bit PCM wav -> (float32 samples in [-1, 1), mixed to mono; rate)."""
    lib = _need()
    out = ctypes.POINTER(ctypes.c_float)()
    rate = ctypes.c_int()
    n = lib.rtts_wav_read_pcm16(str(path).encode(), ctypes.byref(out),
                                ctypes.byref(rate))
    if n < 0:
        raise IOError(f"native wav read failed for {path}")
    data = np.ctypeslib.as_array(out, shape=(n,)).copy()
    lib.rtts_free(out)
    calls["wav_read"] += 1
    return data, rate.value


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    lib = _need()
    x = np.ascontiguousarray(x, np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.rtts_resample(_fptr(x), len(x), orig_sr, target_sr,
                          ctypes.byref(out))
    y = np.ctypeslib.as_array(out, shape=(n,)).copy()
    lib.rtts_free(out)
    calls["resample"] += 1
    return y


def trim_silence(x: np.ndarray, sample_rate: int, threshold_db: float = -40.0,
                 frame_ms: float = 20.0) -> np.ndarray:
    lib = _need()
    x = np.ascontiguousarray(x, np.float32)
    start = ctypes.c_int64()
    end = ctypes.c_int64()
    lib.rtts_trim_silence(_fptr(x), len(x), sample_rate, threshold_db,
                          frame_ms, ctypes.byref(start), ctypes.byref(end))
    calls["trim_silence"] += 1
    return x[start.value:end.value]


class NativeClipLoader:
    """Threaded prefetching clip loader over .rclip files."""

    def __init__(self, paths: Sequence[str], n_workers: int = 4,
                 cache_bytes: int = 1 << 30):
        lib = _need()
        self._lib = lib
        arr = (ctypes.c_char_p * len(paths))(
            *[str(p).encode() for p in paths])
        self._handle = lib.rtts_loader_create(arr, len(paths), n_workers,
                                              cache_bytes)
        self._n = len(paths)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.rtts_loader_destroy(self._handle)
            self._handle = None

    def prefetch(self, indices: Sequence[int]) -> None:
        idx = np.ascontiguousarray(indices, np.int32)
        self._lib.rtts_loader_prefetch(self._handle, _iptr(idx), len(idx))
        calls["prefetch"] += 1

    def fill_batch(self, indices: Sequence[int], t_pad: int, m_pad: int,
                   n_mels: int) -> dict:
        """{tokens (B, t_pad) int32, token_mask (B, t_pad) bool, mel (B,
        m_pad, n_mels) float32, mel_mask (B, m_pad) bool}, zero-padded."""
        bsz = len(indices)
        idx = np.ascontiguousarray(indices, np.int32)
        tokens = np.empty((bsz, t_pad), np.int32)
        tmask = np.empty((bsz, t_pad), np.uint8)
        mel = np.empty((bsz, m_pad, n_mels), np.float32)
        mmask = np.empty((bsz, m_pad), np.uint8)
        rc = self._lib.rtts_loader_fill_batch(
            self._handle, _iptr(idx), bsz, t_pad, m_pad, n_mels,
            tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            tmask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            _fptr(mel),
            mmask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise IOError(f"native batch fill failed (rc={rc})")
        calls["fill_batch"] += 1
        return {"tokens": tokens, "token_mask": tmask.astype(bool),
                "mel": mel, "mel_mask": mmask.astype(bool)}

    def fill_crops(self, indices: Sequence[int], frame_offsets: Sequence[int],
                   frames: int, hop: int, n_mels: int) -> dict:
        """{mel (B, frames, n_mels), audio (B, frames * hop)} float32: row
        r's frames from ``frame_offsets[r]`` and the matching samples."""
        bsz = len(indices)
        idx = np.ascontiguousarray(indices, np.int32)
        offs = np.ascontiguousarray(frame_offsets, np.int32)
        mel = np.empty((bsz, frames, n_mels), np.float32)
        audio = np.empty((bsz, frames * hop), np.float32)
        rc = self._lib.rtts_loader_fill_crops(
            self._handle, _iptr(idx), _iptr(offs), bsz, frames, hop, n_mels,
            _fptr(mel), _fptr(audio))
        if rc != 0:
            raise IOError(f"native crop fill failed (rc={rc})")
        calls["fill_crops"] += 1
        return {"mel": mel, "audio": audio}
