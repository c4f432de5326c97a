"""End-to-end text -> waveform inference: ``Synthesizer``.

Port of ``rtts/infer/synthesize.py``: text -> token ids (``rtts_torch.text``)
-> encoder -> greedy decode (any cache of ``decode_greedy``, in
``kv_cache_dtype``) -> postnet -> SqueezeWave inverse (whole, or in chunks
with ``streaming_chunk``), or Griffin-Lim on the Synthesizer's device when
no vocoder is given.  The serving surfaces: ``serve_to_mel``/``serve``
bucket requests by predicted length and decode each bucket at its own
budget; ``serve_continuous_to_mel``/``serve_continuous`` recycle decode
slots through ``rtts_torch.infer.serving.serve_pool``.

``mesh`` (this rank's ``rtts_torch.parallel.mesh.Mesh``; every rank of it
builds its Synthesizer and makes the same calls) serves over several
ranks, as the reference's: the TTS weights tensor-parallel over the model
group (``shard_for_serving``, unless ``tensor_parallel`` is false), the
vocoder whole on each rank, and a decode's requests split over the data
group, the batch padded to a multiple of the data-parallel size by
repeating the last request; every rank returns the whole batch's mel and
lengths, the padding trimmed.  A stack with ``seq_parallel_axis`` or
``pipeline_axis`` keeps its weights whole; an encoder that splits its
sequence over the model group pads the tokens to a multiple of the rank
count (masked, so the attention and the memory the decoder reads are
unchanged) rather than raising the reference's ValueError.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rtts_torch.audio.griffin import mel_to_audio as gl_mel_to_audio
from rtts_torch.config import Config
from rtts_torch.infer.decode import (_kv_dtype, _precast_weights,
                                     decode_greedy)
from rtts_torch.models import reformer_tts as M
from rtts_torch.models import squeezewave
from rtts_torch.parallel.collectives import batch_shard
from rtts_torch.parallel.mesh import current_mesh
from rtts_torch.parallel.serving import (data_parallel_size,
                                         gather_request_batch,
                                         replicate_for_serving,
                                         shard_for_serving,
                                         shard_request_batch)
from rtts_torch.parallel.sharding import whole_stacks
from rtts_torch.text import encode_batch, token_lengths


class Synthesizer:
    def __init__(self, cfg: Config, tts_model: M.ReformerTTS, vocoder=None,
                 max_frames: int = 1024, mode: str = "auto", unroll: int = 1,
                 staged="auto", mesh=None, attn_window=None,
                 tensor_parallel: bool = True):
        """``tts_model`` and ``vocoder`` are modules on the device to serve
        from.  The TTS weights are cast to the compute dtype once, in place;
        the vocoder is weight-norm folded at load (a copy if it is not
        folded yet).  ``mode``, ``unroll``, ``staged`` and ``attn_window``
        (w_back, w_fwd) go to ``decode_greedy``; an unknown
        ``kv_cache_dtype`` raises here."""
        cdt = M._dtype(cfg.model.compute_dtype)
        _kv_dtype(cfg.model, cdt)
        self.cfg = cfg
        self.mesh = mesh
        self.tts = _precast_weights(tts_model, cdt)
        self.vocoder = (squeezewave.ensure_folded(vocoder)
                        if vocoder is not None else None)
        if mesh is not None:
            self.tts = shard_for_serving(self.tts, mesh, tensor_parallel,
                                         whole_stacks(cfg.model))
            if self.vocoder is not None:
                self.vocoder = replicate_for_serving(self.vocoder, mesh)
        self.device = next(tts_model.parameters()).device
        self.max_frames = max_frames
        self.mode = mode
        self.unroll = unroll
        self.staged = staged
        self.attn_window = (tuple(attn_window) if attn_window is not None
                            else None)

    def _tokens(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        tcfg = self.cfg.dataset.text
        return encode_batch(texts, cleaner=tcfg.cleaner,
                            pad_to_multiple=tcfg.pad_to_multiple,
                            max_len=tcfg.max_len, level=tcfg.level)

    @torch.no_grad()
    def _decode_group(self, texts: Sequence[str], max_frames: int,
                      seed: int) -> Tuple[np.ndarray, np.ndarray]:
        tokens, mask = self._tokens(texts)
        tokens = torch.as_tensor(tokens, device=self.device).long()
        mask = torch.as_tensor(mask, device=self.device).bool()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        n, shard = tokens.shape[0], contextlib.nullcontext()
        if self.mesh is not None and data_parallel_size(self.mesh) > 1:
            # pad by repeating the last request (all-pad rows would decode
            # degenerately), then take this data rank's rows
            extra = -n % data_parallel_size(self.mesh)
            tokens = torch.cat([tokens, tokens[-1:].expand(extra, -1)])
            mask = torch.cat([mask, mask[-1:].expand(extra, -1)])
            (tokens, mask), off, total = shard_request_batch((tokens, mask),
                                                             self.mesh)
            shard = batch_shard(off, total, self.mesh.data_group)
        with shard, (self.mesh or contextlib.nullcontext()):
            memory = M.encode(self.tts, self.cfg.model, tokens, mask,
                              multiple=self._seq_multiple())
            mel, lengths, _ = decode_greedy(
                self.tts, self.cfg.model, memory, mask, max_frames=max_frames,
                generator=gen, mode=self.mode, unroll=self.unroll,
                staged=self.staged, attn_window=self.attn_window)
        if self.mesh is not None and data_parallel_size(self.mesh) > 1:
            mel = gather_request_batch(mel, self.mesh)[:n]
            lengths = gather_request_batch(lengths, self.mesh)[:n]
        return mel.cpu().numpy(), lengths.cpu().numpy()

    def _seq_multiple(self) -> int:
        """The rank count a sequence-parallel encoder splits the tokens
        over (the encoder pads them to a multiple of it), else 1."""
        if not self.cfg.model.encoder.seq_parallel_axis:
            return 1
        mesh = self.mesh or current_mesh()
        return mesh.model_size if mesh is not None else 1

    def text_to_mel(self, texts: Sequence[str], seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (mel (B, T_max, n_mels) float32, lengths (B,) int32).
        ``seed`` seeds the decoder prenet's always-on dropout."""
        return self._decode_group(texts, self.max_frames, seed)

    def mel_to_audio(self, mel: np.ndarray, length: Optional[int] = None,
                     streaming_chunk: int = 0) -> np.ndarray:
        """One utterance (T, n_mels) -> waveform through the vocoder, with
        its noise drawn from a generator seeded 0 (as the reference's
        default key), or through Griffin-Lim when there is no vocoder
        (which ignores ``streaming_chunk``, as the reference's does).
        ``streaming_chunk`` > 0 vocodes that many frames at a time with
        receptive-field context: the same z, the same samples."""
        if length is not None:
            mel = mel[:length]
        mel_t = torch.as_tensor(np.asarray(mel), dtype=torch.float32,
                                device=self.device)
        if self.vocoder is None:
            return gl_mel_to_audio(mel_t, self.cfg.dataset.audio).cpu().numpy()
        gen = torch.Generator(device=self.device).manual_seed(0)
        if streaming_chunk > 0:
            audio = squeezewave.infer_streaming(
                self.vocoder, self.cfg.vocoder, mel_t[None], generator=gen,
                chunk_frames=streaming_chunk)
        else:
            audio = squeezewave.infer(self.vocoder, self.cfg.vocoder,
                                      mel_t[None], generator=gen)
        return audio[0].cpu().numpy()

    def __call__(self, texts: Sequence[str], seed: int = 0) -> List[np.ndarray]:
        mel, lengths = self.text_to_mel(texts, seed)
        return [self.mel_to_audio(mel[i], int(lengths[i]))
                for i in range(len(texts))]

    # -- variable-length batching ------------------------------------------------

    def _frame_quantum(self) -> int:
        """Budgets and capacity classes quantize to lcm(64, r): 64 the
        chunk/stage alignment, r the reduction factor."""
        r = self.cfg.model.reduction_factor
        return 64 * r // math.gcd(64, r)

    def predict_frames(self, texts: Sequence[str],
                       frames_per_token: float = 8.0,
                       min_frames: int = 64) -> List[int]:
        """Per-request mel-frame budgets from token counts, quantized up to
        ``_frame_quantum`` and capped at ``max_frames``.  Overestimate the
        speech rate: ``serve_to_mel`` escalates a request that hits its
        budget."""
        tcfg = self.cfg.dataset.text
        m = self._frame_quantum()
        out = []
        for n_tok in token_lengths(texts, cleaner=tcfg.cleaner,
                                   level=tcfg.level):
            b = max(min_frames, int(math.ceil(frames_per_token * n_tok)))
            out.append(min(self.max_frames, -(-b // m) * m))
        return out

    def serve_to_mel(self, texts: Sequence[str], seed: int = 0,
                     frames_per_token: float = 8.0, min_frames: int = 64,
                     escalate: bool = True
                     ) -> Tuple[List[np.ndarray], List[int]]:
        """Bucketed batching: requests grouped by predicted budget, each
        group decoded at its own max_frames; a request whose length reached
        its budget (below ``max_frames``) may have been cut, and with
        ``escalate`` is decoded again at ``max_frames``.  -> per-request
        (mel (T_i, n_mels), length)."""
        budgets = self.predict_frames(texts, frames_per_token, min_frames)
        groups: dict = {}
        for i, b in enumerate(budgets):
            groups.setdefault(b, []).append(i)
        mels: List[Optional[np.ndarray]] = [None] * len(texts)
        lengths: List[int] = [0] * len(texts)
        needs_full: List[int] = []
        for budget, idxs in sorted(groups.items()):
            mel, lens = self._decode_group([texts[i] for i in idxs], budget,
                                           seed)
            for j, i in enumerate(idxs):
                li = int(lens[j])
                if escalate and li >= budget and budget < self.max_frames:
                    needs_full.append(i)
                else:
                    mels[i], lengths[i] = mel[j, :li], li
        if needs_full:
            mel, lens = self._decode_group([texts[i] for i in needs_full],
                                           self.max_frames, seed)
            for j, i in enumerate(needs_full):
                li = int(lens[j])
                mels[i], lengths[i] = mel[j, :li], li
        return mels, lengths  # type: ignore[return-value]

    def serve(self, texts: Sequence[str], seed: int = 0,
              frames_per_token: float = 8.0, min_frames: int = 64,
              escalate: bool = True) -> List[np.ndarray]:
        """Bucketed text -> wav (see ``serve_to_mel``)."""
        mels, _ = self.serve_to_mel(texts, seed, frames_per_token,
                                    min_frames, escalate)
        return [self.mel_to_audio(m) for m in mels]

    # -- continuous batching -------------------------------------------------------

    def serve_continuous_to_mel(self, texts: Sequence[str], seed: int = 0,
                                frames_per_token: float = 8.0,
                                min_frames: int = 64, slots: int = 8,
                                segment_frames: int = 64,
                                escalate: bool = True, fetch: bool = True
                                ) -> Tuple[List[Any], List[int]]:
        """Continuous batching through ``serving.serve_pool``: requests go
        to the smallest power-of-two capacity class (quantized as
        ``predict_frames``) covering their budget, and within a class the
        slots are recycled as requests stop.  Escalation as in
        ``serve_to_mel``.  -> per-request (mel (T_i, n_mels) np.float32,
        length); with ``fetch=False`` device rows of the class capacity,
        zero beyond each length."""
        from rtts_torch.infer.serving import serve_pool

        budgets = self.predict_frames(texts, frames_per_token, min_frames)
        tokens, mask = self._tokens(texts)
        r = self.cfg.model.reduction_factor
        m = self._frame_quantum()
        top = -(-self.max_frames // m) * m
        caps = tuple(sorted({-(-c // m) * m for c in
                             (128, 256, 512, 1024, 2048, 4096, 8192)
                             if -(-c // m) * m < top} | {top}))
        seg = max(r, segment_frames - segment_frames % r)

        def run(idx, bud):
            return serve_pool(self.tts, self.cfg.model, tokens[idx],
                              mask[idx], bud, class_caps=caps, slots=slots,
                              segment_frames=seg, seed=seed)

        dmels, lens = run(list(range(len(texts))), budgets)
        mels: List[Any] = [None] * len(texts)
        lengths: List[int] = [0] * len(texts)
        needs_full: List[int] = []
        for i in range(len(texts)):
            li = int(lens[i])
            if escalate and li >= budgets[i] and budgets[i] < self.max_frames:
                needs_full.append(i)
            else:
                mels[i], lengths[i] = dmels[i], li
        if needs_full:
            dmels, lens = run(needs_full, [self.max_frames] * len(needs_full))
            for j, i in enumerate(needs_full):
                mels[i], lengths[i] = dmels[j], int(lens[j])
        if fetch:   # slice on the device: fetch each length, not the row
            mels = [row[:li].cpu().numpy() for row, li in zip(mels, lengths)]
        return mels, lengths

    def serve_continuous(self, texts: Sequence[str], seed: int = 0,
                         frames_per_token: float = 8.0, min_frames: int = 64,
                         slots: int = 8, segment_frames: int = 64,
                         vocode: str = "batched", escalate: bool = True
                         ) -> List[np.ndarray]:
        """Continuous-batching text -> wav (see ``serve_continuous_to_mel``).

        ``vocode="batched"`` stacks the device rows of each capacity class
        and runs one ``squeezewave.infer`` a class (its noise from a
        generator seeded 0), slicing each waveform to its length;
        ``"exact"`` vocodes each trimmed mel through ``mel_to_audio``, as
        ``__call__`` does.  The two draw different z, so their waveforms
        differ sample by sample; the zero padding changes the conditioning
        only within the receptive field of each stop."""
        if vocode not in ("batched", "exact"):
            raise ValueError(f"vocode must be 'batched' or 'exact', "
                             f"got {vocode!r}")
        kw = dict(seed=seed, frames_per_token=frames_per_token,
                  min_frames=min_frames, slots=slots,
                  segment_frames=segment_frames, escalate=escalate)
        if vocode == "exact" or self.vocoder is None:
            mels, _ = self.serve_continuous_to_mel(texts, **kw)
            return [self.mel_to_audio(m) for m in mels]
        rows, lengths = self.serve_continuous_to_mel(texts, fetch=False, **kw)
        hop = self.cfg.vocoder.hop_length
        by_cap: dict = {}
        for i, row in enumerate(rows):
            by_cap.setdefault(int(row.shape[0]), []).append(i)
        wavs: List[Optional[np.ndarray]] = [None] * len(texts)
        with torch.no_grad():
            for _, idxs in sorted(by_cap.items()):
                gen = torch.Generator(device=self.device).manual_seed(0)
                audio = squeezewave.infer(
                    self.vocoder, self.cfg.vocoder,
                    torch.stack([rows[i] for i in idxs]),
                    generator=gen).cpu().numpy()
                for j, i in enumerate(idxs):
                    wavs[i] = audio[j, :lengths[i] * hop]
        return wavs  # type: ignore[return-value]
