"""Streaming text -> wav: ``StreamingSynthesizer``.

Port of ``rtts/infer/streaming.py``.  Per segment of ``chunk_frames`` mel
frames:

1. the decoder (``decode._Decoder``, fixed buffers: the reference's
   ``staged=False``) runs ``chunk_frames // r`` steps, with no host
   synchronization; a step after every row stopped writes nothing that
   can be observed (as ``decode_greedy``'s ``unroll`` does);
2. the postnet runs over the new frames with ``pn_ctx`` frames of context
   on each side, so every finalized frame equals the full-utterance
   postnet's;
3. the vocoder runs over the frames whose context is final, with
   receptive-field context and a slice of one noise tensor drawn for the
   whole utterance, so the kept samples are the single pass's
   (``squeezewave.infer_streaming``);
4. the finished audio (or mel, without a vocoder) is yielded.

The decoded frames equal ``decode_greedy(mode, staged=False)``'s bit for
bit (the same step at the same shapes).  The host synchronizes once a
segment, to read whether every row stopped: steps 2-4 are launched for the
case that they did not, before that read, and the chunk's copy to the host
rides the same synchronization.  When every row stopped, the tail after
the stop is computed as the reference computes it, which takes one more.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from rtts_torch.config import Config, ReformerTTSConfig
from rtts_torch.infer.decode import (MODES, _auto_mode, _Decoder,
                                     _decode_rotations, _kv_dtype,
                                     _local_spec, _precast_weights)
from rtts_torch.infer.serving import _device, _to_device, _to_host
from rtts_torch.models import reformer_tts as M
from rtts_torch.models import squeezewave
from rtts_torch.models.reformer_tts import _dtype, postnet_apply
from rtts_torch.text import encode_batch

# the vocoder noise's seed namespace, apart from the prenet dropout's
# generator (the reference's fold-in constant)
_VOC_KEY = 77


def _postnet_context(cfg: ReformerTTSConfig) -> int:
    """One-sided postnet receptive field in mel frames."""
    return cfg.postnet_layers * (cfg.postnet_kernel - 1) // 2


def _voc_seed(seed: int) -> int:
    return int(np.random.SeedSequence([seed, _VOC_KEY]).generate_state(
        1, np.uint64)[0])


class StreamingSynthesizer:
    """Incremental text -> wav: iterate over audio chunks as they decode::

        ss = StreamingSynthesizer(cfg, tts_model, vocoder)
        for audio_chunk in ss.stream(["hello world"], chunk_frames=64):
            play(audio_chunk)   # (B, samples) per iteration
    """

    def __init__(self, cfg: Config, tts_model: M.ReformerTTS, vocoder=None,
                 max_frames: int = 1024, mode: str = "kv_full",
                 attn_window=None):
        """``tts_model`` and ``vocoder`` are modules on the device to serve
        from (the TTS weights cast to the compute dtype in place, the
        vocoder folded).  ``mode``: the decode cache, kv_full (default),
        kv_lsh, kv_lsh_chunk, kv_local or auto (``decode._auto_mode``).
        ``attn_window=(w_back, w_fwd)``: monotonic cross-attention
        windowing, as in ``decode_greedy``; the tracker rides the decoder
        across segments."""
        mcfg = cfg.model
        cdt = _dtype(mcfg.compute_dtype)
        _kv_dtype(mcfg, cdt)
        self.cfg = cfg
        self.tts = _precast_weights(tts_model, cdt)
        self.vocoder = (squeezewave.ensure_folded(vocoder)
                        if vocoder is not None else None)
        self.device = _device(tts_model)
        r = mcfg.reduction_factor
        if max_frames % r:
            raise ValueError("max_frames must be a multiple of "
                             "reduction_factor")
        if max_frames // r > mcfg.max_pos:
            raise ValueError(f"max_frames {max_frames} needs {max_frames // r}"
                             f" decoder positions; the table has "
                             f"{mcfg.max_pos}")
        self.max_frames = max_frames
        if mode == "auto":
            mode = _auto_mode(mcfg, max_frames)
        if mode not in MODES:
            raise ValueError(f"unknown decode mode {mode!r} (want kv_full, "
                             "kv_lsh, kv_lsh_chunk, kv_local or auto)")
        self.mode = mode
        self.local_spec = None
        if mode == "kv_local":
            self.local_spec = _local_spec(mcfg, max_frames // r)
            if all(s is None for s in self.local_spec):
                raise ValueError("kv_local needs a decoder self-attention "
                                 "layer of resolved kind 'local'")
        self.attn_window = None
        if attn_window is not None:
            wb, wf = attn_window
            if wb < 0 or wf < 1:
                raise ValueError(
                    f"attn_window must satisfy w_back >= 0 and w_fwd >= 1 "
                    f"(the tracker must be able to advance), "
                    f"got {attn_window}")
            self.attn_window = (int(wb), int(wf))

    def _decoder(self, tokens, tmask, seed: int) -> _Decoder:
        mcfg, dev = self.cfg.model, self.device
        memory = M.encode(self.tts, mcfg, tokens, tmask)
        gen = torch.Generator(device=dev).manual_seed(seed)
        rotations, nb = None, 0
        if self.mode in ("kv_lsh", "kv_lsh_chunk"):
            rotations, nb = _decode_rotations(mcfg, gen, self.max_frames, dev)
        n_groups = self.max_frames // mcfg.reduction_factor
        return _Decoder(self.tts, mcfg, memory, tmask, n_groups, n_groups,
                        self.mode, gen, mcfg.stop_threshold, rotations, nb,
                        self.local_spec, self.attn_window)

    def _postnet(self, dec: _Decoder, post: torch.Tensor, pn_done: int,
                 pn_target: int) -> None:
        """Finalize ``post`` frames [pn_done, pn_target) from a window of
        the decoded mel with the postnet's context on each side."""
        if pn_target <= pn_done:
            return
        ctx, cdt = _postnet_context(self.cfg.model), dec.cdt
        lo = max(0, pn_done - ctx)
        hi = min(self.max_frames, pn_target + ctx)
        win = dec.mel[:, lo:hi]
        out = win + postnet_apply(self.tts.postnet, win.to(cdt), cdt).float()
        post[:, pn_done:pn_target] = out[:, pn_done - lo:pn_target - lo]

    def _chunk(self, post: torch.Tensor, z_full, pn_done: int, emitted: int,
               ready: int) -> torch.Tensor:
        """The output for frames [emitted, ready): the final mel, or the
        vocoder's samples from a window with receptive-field context."""
        if self.vocoder is None:
            return post[:, emitted:ready]
        vcfg = self.cfg.vocoder
        per_frame = vcfg.hop_length // vcfg.n_group
        ctx = self._voc_ctx()
        vlo, vhi = max(0, emitted - ctx), min(pn_done, ready + ctx)
        audio = squeezewave._infer_chunk(
            self.vocoder, post[:, vlo:vhi],
            z_full[:, vlo * per_frame:vhi * per_frame], cfg=vcfg)
        keep = (emitted - vlo) * vcfg.hop_length
        return audio[:, keep:keep + (ready - emitted) * vcfg.hop_length]

    def _voc_ctx(self) -> int:
        """The vocoder's context in mel frames (0 without a vocoder)."""
        if self.vocoder is None:
            return 0
        vcfg = self.cfg.vocoder
        return -(-squeezewave.receptive_field_squeezed(vcfg)
                 // (vcfg.hop_length // vcfg.n_group))

    def _emit(self, dec, post, z_full, pn_done: int, emitted: int,
              t_frames: int, finished: bool
              ) -> Tuple[int, int, Optional[torch.Tensor]]:
        """Finalize and produce what decoding to ``t_frames`` allows ->
        (pn_done, emitted, the chunk or None).  The postnet is non-causal:
        a frame is final once decoding is ``pn_ctx`` past it, or at once
        when decoding finished (the buffer past it is zeros, as in the
        full pipeline).  Audio waits for its vocoder context."""
        pn_ctx, big_t = _postnet_context(self.cfg.model), self.max_frames
        pn_target = (min(big_t, t_frames + pn_ctx) if finished
                     else max(pn_done, t_frames - pn_ctx))
        self._postnet(dec, post, pn_done, pn_target)
        pn_done = max(pn_done, pn_target)
        ready = pn_done if finished else max(emitted,
                                             pn_done - self._voc_ctx())
        ready = min(ready, big_t)
        if ready <= emitted:
            return pn_done, emitted, None
        return pn_done, ready, self._chunk(post, z_full, pn_done, emitted,
                                           ready)

    @torch.no_grad()
    def stream(self, texts: Sequence[str], chunk_frames: int = 64,
               seed: int = 0) -> Iterator[np.ndarray]:
        """Yield (B, samples) audio arrays (or (B, frames, n_mels) mel
        without a vocoder) until every utterance stops; the last may be
        shorter.  ``seed`` seeds the prenet dropout (and, apart from it,
        the vocoder's noise).  Afterwards ``self.last_lengths`` holds the
        frames decoded per utterance, and ``self.last_mel`` the decoded
        frames before the postnet (B, max_frames, n_mels), on the
        device."""
        mcfg, vcfg, dev = self.cfg.model, self.cfg.vocoder, self.device
        r, big_t = mcfg.reduction_factor, self.max_frames
        if chunk_frames % r or chunk_frames < r:
            raise ValueError("chunk_frames must be a positive multiple of "
                             "reduction_factor")
        tcfg = self.cfg.dataset.text
        tokens, tmask = encode_batch(list(texts), cleaner=tcfg.cleaner,
                                     pad_to_multiple=tcfg.pad_to_multiple,
                                     max_len=tcfg.max_len, level=tcfg.level)
        tokens = _to_device(tokens.astype(np.int64), dev)
        tmask = _to_device(tmask, dev)
        dec = self._decoder(tokens, tmask, seed)
        b = tokens.shape[0]
        z_full = None
        if self.vocoder is not None:
            per_frame = vcfg.hop_length // vcfg.n_group
            gen = torch.Generator(device=dev).manual_seed(_voc_seed(seed))
            z_full = torch.randn((b, big_t * per_frame, vcfg.n_group),
                                 generator=gen, device=dev) * vcfg.sigma
        # final post-netted frames, on the device
        post = torch.zeros(b, big_t, mcfg.n_mels, device=dev)
        pn_done = emitted = t = 0
        while True:
            live = None
            for _ in range(max(1, min(chunk_frames, big_t - t * r) // r)):
                dec.step(t, live)
                t += 1
                live = ~dec.done.all()
            t_frames = t * r
            # launched for the case that some row still decodes
            spec = self._emit(dec, post, z_full, pn_done, emitted, t_frames,
                              finished=False)
            chunk = None if spec[2] is None else _to_host(spec[2])
            state = torch.cat([dec.done.all()[None].to(torch.int32),
                               dec.lengths]).cpu().numpy()   # the sync
            all_done, lengths = bool(state[0]), state[1:]
            if not all_done and t_frames < big_t:
                pn_done, emitted = spec[0], spec[1]
                if chunk is not None:
                    yield chunk.numpy()
                continue
            # every row stopped (at its longest length) or the buffer is
            # full: the tail as the reference computes it
            t_eff = int(lengths.max()) if all_done else t_frames
            pn_done, emitted, tail = self._emit(dec, post, z_full, pn_done,
                                                emitted, t_eff, finished=True)
            self.last_lengths, self.last_mel = lengths, dec.mel
            if tail is not None:
                yield tail.cpu().numpy()
            return
