"""The training data pipeline of the port: a copy of the parts of
``rtts/data/dataset.py`` that TTS and vocoder training use.

``Manifest`` and ``split_manifest`` (the train/val split), ``ClipStore``
(``.rclip`` or ``.npz`` clips), the length-bucketed ``TextMelDataset``, the
deterministic step -> batch ``EpochBatcher`` and the vocoder's
``MelAudioDataset`` (mel window, audio crop), with the same batches and
crops as the JAX package's (``tests/test_torch_copies.py``).  The JAX
package's optional C++ prefetching loader is not part of the copy: the
clips are read and collated in Python whatever ``num_workers`` says, which
gives the same batches.  ``to_device`` turns a numpy batch into tensors on
the training device.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rtts_torch.config import DatasetConfig
from rtts_torch.text.symbols import PAD_ID


def read_clip(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tokens, mel, audio) of one ``.rclip`` file (the format
    ``rtts/data/preprocess.py`` writes: magic, five uint32 sizes, then
    int32 tokens, f32 mel frames and f32 samples)."""
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


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m if m > 1 else n


@dataclass
class Manifest:
    sample_rate: int
    hop_length: int
    n_mels: int
    clips: List[dict]

    @classmethod
    def load(cls, path) -> "Manifest":
        with open(path) as f:
            d = json.load(f)
        return cls(d["sample_rate"], d["hop_length"], d["n_mels"], d["clips"])


def split_manifest(man: Manifest, val_fraction: float, seed: int
                   ) -> Tuple[Manifest, Manifest]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(man.clips))
    n_val = max(1, int(len(man.clips) * val_fraction))
    val_ids = set(idx[:n_val].tolist())
    tr = [c for i, c in enumerate(man.clips) if i not in val_ids]
    va = [c for i, c in enumerate(man.clips) if i in val_ids]
    return (Manifest(man.sample_rate, man.hop_length, man.n_mels, tr),
            Manifest(man.sample_rate, man.hop_length, man.n_mels, va))


class ClipStore:
    """Loads clip files (.rclip or legacy .npz), with a small LRU-ish cache."""

    def __init__(self, max_cached: int = 512):
        self._cache: Dict[str, dict] = {}
        self._max = max_cached

    def load(self, path: str) -> dict:
        hit = self._cache.get(path)
        if hit is not None:
            return hit
        if str(path).endswith(".rclip"):
            tokens, mel, audio = read_clip(path)
            d = {"tokens": tokens, "mel": mel, "audio": audio}
        else:
            with np.load(path) as z:
                d = {k: z[k] for k in z.files}
        if len(self._cache) >= self._max:
            self._cache.pop(next(iter(self._cache)))
        self._cache[path] = d
        return d


class TextMelDataset:
    """(tokens, mel) view with bucketed static-shape batching."""

    def __init__(self, man: Manifest, cfg: DatasetConfig,
                 store: Optional[ClipStore] = None):
        self.man = man
        self.cfg = cfg
        self.store = store or ClipStore()

    def __len__(self) -> int:
        return len(self.man.clips)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        c = self.man.clips[i]
        d = self.store.load(c["clip"])
        return d["tokens"], d["mel"]

    def _bucket_shape(self, items: Sequence[Tuple[np.ndarray, np.ndarray]]
                      ) -> Tuple[int, int]:
        tok = max(len(t) for t, _ in items)
        mel = max(m.shape[0] for _, m in items)
        t_pad = _round_up(tok, self.cfg.text.pad_to_multiple)
        m_pad = min(_round_up(mel, self.cfg.mel_pad_to_multiple),
                    self.cfg.max_mel_len)
        return t_pad, m_pad

    def collate(self, items: Sequence[Tuple[np.ndarray, np.ndarray]]
                ) -> Dict[str, np.ndarray]:
        t_pad, m_pad = self._bucket_shape(items)
        n_mels = items[0][1].shape[1]
        b = len(items)
        tokens = np.full((b, t_pad), PAD_ID, np.int32)
        tmask = np.zeros((b, t_pad), bool)
        mel = np.zeros((b, m_pad, n_mels), np.float32)
        mmask = np.zeros((b, m_pad), bool)
        for r, (t, m) in enumerate(items):
            t = t[:t_pad]
            m = m[:m_pad]
            tokens[r, :len(t)] = t
            tmask[r, :len(t)] = True
            mel[r, :m.shape[0]] = m
            mmask[r, :m.shape[0]] = True
        return {"tokens": tokens, "token_mask": tmask,
                "mel": mel, "mel_mask": mmask}

    def batches(self, batch_size: int, seed: int = 0, shuffle: bool = True,
                drop_last: bool = False, loop: bool = False
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Length-bucketed batch iterator: sort by mel length, slice into
        batches, shuffle batch order — minimizes padding and shape count."""
        order = sorted(range(len(self)),
                       key=lambda i: self.man.clips[i]["n_frames"])
        chunks = [order[i:i + batch_size]
                  for i in range(0, len(order), batch_size)]
        if drop_last and chunks and len(chunks[-1]) < batch_size:
            chunks = chunks[:-1]
        rng = np.random.default_rng(seed)
        while True:
            idx = rng.permutation(len(chunks)) if shuffle else np.arange(len(chunks))
            for ci in idx:
                yield self.collate([self[i] for i in chunks[ci]])
            if not loop:
                return


class EpochBatcher:
    """Deterministic step -> batch mapping for bit-exact mid-epoch resume.

    The epoch permutation is derived from (seed, epoch), so
    ``batch_at(step)`` returns exactly the batch a fresh run would see at
    that global step — the loader needs NO checkpoint state beyond the step
    counter the trainer already saves (SURVEY.md §6.4; the reference's
    Lightning resume restarts the epoch stream, this is strictly stronger).
    """

    def __init__(self, ds: "TextMelDataset", batch_size: int, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = False):
        self.ds = ds
        self.seed = seed
        self.shuffle = shuffle
        order = sorted(range(len(ds)),
                       key=lambda i: ds.man.clips[i]["n_frames"])
        self.chunks = [order[i:i + batch_size]
                       for i in range(0, len(order), batch_size)]
        if drop_last and self.chunks and len(self.chunks[-1]) < batch_size:
            self.chunks = self.chunks[:-1]
        self._perm_epoch = -1
        self._perm = None

    def steps_per_epoch(self) -> int:
        return len(self.chunks)

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        if epoch != self._perm_epoch:
            if self.shuffle:
                rng = np.random.default_rng((self.seed, epoch))
                self._perm = rng.permutation(len(self.chunks))
            else:
                self._perm = np.arange(len(self.chunks))
            self._perm_epoch = epoch
        return self._perm

    def _chunk_at(self, step: int) -> List[int]:
        epoch, pos = divmod(step, len(self.chunks))
        return self.chunks[self._epoch_perm(epoch)[pos]]

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return self.ds.collate([self.ds[i] for i in self._chunk_at(step)])


class MelAudioDataset:
    """(mel window, audio crop) pairs for vocoder training."""

    def __init__(self, man: Manifest, segment_samples: int,
                 store: Optional[ClipStore] = None):
        self.man = man
        self.hop = man.hop_length
        if segment_samples % self.hop != 0:
            raise ValueError("segment length must be a multiple of hop")
        self.segment = segment_samples
        self.frames = segment_samples // self.hop
        self.store = store or ClipStore()
        # only clips long enough for one crop
        self.usable = [c for c in man.clips
                       if c["n_samples"] >= self.segment]
        if not self.usable:
            raise ValueError("no clip long enough for the crop length")

    def sample(self, rng: np.random.Generator, batch_size: int
               ) -> Dict[str, np.ndarray]:
        """``batch_size`` random crops: clip picks, then frame offsets, drawn
        from ``rng`` in the reference's order -> {mel (B, frames, n_mels),
        audio (B, segment)} float32."""
        picks = [int(rng.integers(len(self.usable))) for _ in range(batch_size)]
        offsets = []
        for p in picks:
            max_f = self.usable[p]["n_frames"] - self.frames
            offsets.append(int(rng.integers(0, max_f + 1)))
        mels, audios = [], []
        for p, f0 in zip(picks, offsets):
            d = self.store.load(self.usable[p]["clip"])
            mels.append(d["mel"][f0:f0 + self.frames])
            s0 = f0 * self.hop
            audios.append(d["audio"][s0:s0 + self.segment])
        return {"mel": np.stack(mels).astype(np.float32),
                "audio": np.stack(audios).astype(np.float32)}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """tokens -> int64, token_mask / mel_mask -> bool, mel -> float32."""
    return {
        "tokens": torch.as_tensor(np.asarray(batch["tokens"]),
                                  device=device).long(),
        "token_mask": torch.as_tensor(np.asarray(batch["token_mask"]),
                                      device=device).bool(),
        "mel": torch.as_tensor(np.asarray(batch["mel"], np.float32),
                               device=device),
        "mel_mask": torch.as_tensor(np.asarray(batch["mel_mask"]),
                                    device=device).bool(),
    }
