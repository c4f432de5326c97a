"""End-to-end text -> waveform inference: ``Synthesizer``.

Port of ``rtts/infer/synthesize.py``: text -> token ids (``rtts_torch.text``)
-> encoder -> greedy decode (any cache of ``decode_greedy``, in
``kv_cache_dtype``) -> postnet -> SqueezeWave inverse, or Griffin-Lim on the
Synthesizer's device when no vocoder is given.  Not ported yet, and raising
NotImplementedError: multi-device serving (``mesh``), streaming vocoding
and the ``serve*`` batching surfaces.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from rtts_torch.audio.griffin import mel_to_audio as gl_mel_to_audio
from rtts_torch.config import Config
from rtts_torch.infer.decode import (_kv_dtype, _precast_weights,
                                     decode_greedy)
from rtts_torch.models import reformer_tts as M
from rtts_torch.models import squeezewave
from rtts_torch.text import encode_batch


class Synthesizer:
    def __init__(self, cfg: Config, tts_model: M.ReformerTTS, vocoder=None,
                 max_frames: int = 1024, mode: str = "auto", unroll: int = 1,
                 staged="auto", mesh=None, attn_window=None):
        """``tts_model`` and ``vocoder`` are modules on the device to serve
        from.  The TTS weights are cast to the compute dtype once, in place;
        the vocoder is weight-norm folded at load (a copy if it is not
        folded yet).  ``mode``, ``unroll``, ``staged`` and ``attn_window``
        (w_back, w_fwd) go to ``decode_greedy``; an unknown
        ``kv_cache_dtype`` raises here."""
        if mesh is not None:
            raise NotImplementedError(
                "rtts_torch: mesh serving is not ported yet")
        cdt = M._dtype(cfg.model.compute_dtype)
        _kv_dtype(cfg.model, cdt)
        self.cfg = cfg
        self.tts = _precast_weights(tts_model, cdt)
        self.vocoder = (squeezewave.ensure_folded(vocoder)
                        if vocoder is not None else None)
        self.device = next(tts_model.parameters()).device
        self.max_frames = max_frames
        self.mode = mode
        self.unroll = unroll
        self.staged = staged
        self.attn_window = (tuple(attn_window) if attn_window is not None
                            else None)

    @torch.no_grad()
    def text_to_mel(self, texts: Sequence[str], seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (mel (B, T_max, n_mels) float32, lengths (B,) int32).
        ``seed`` seeds the decoder prenet's always-on dropout."""
        tcfg = self.cfg.dataset.text
        tokens, mask = encode_batch(texts, cleaner=tcfg.cleaner,
                                    pad_to_multiple=tcfg.pad_to_multiple,
                                    max_len=tcfg.max_len, level=tcfg.level)
        tokens = torch.as_tensor(np.asarray(tokens), device=self.device).long()
        mask = torch.as_tensor(np.asarray(mask), device=self.device).bool()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        memory = M.encode(self.tts, self.cfg.model, tokens, mask)
        mel, lengths, _ = decode_greedy(self.tts, self.cfg.model, memory, mask,
                                        max_frames=self.max_frames,
                                        generator=gen, mode=self.mode,
                                        unroll=self.unroll,
                                        staged=self.staged,
                                        attn_window=self.attn_window)
        return mel.cpu().numpy(), lengths.cpu().numpy()

    def mel_to_audio(self, mel: np.ndarray, length: Optional[int] = None,
                     streaming_chunk: int = 0) -> np.ndarray:
        """One utterance (T, n_mels) -> waveform through the vocoder, with
        its noise drawn from a generator seeded 0 (as the reference's
        default key), or through Griffin-Lim when there is no vocoder
        (which ignores ``streaming_chunk``, as the reference's does)."""
        if length is not None:
            mel = mel[:length]
        mel_t = torch.as_tensor(np.asarray(mel), dtype=torch.float32,
                                device=self.device)
        if self.vocoder is None:
            return gl_mel_to_audio(mel_t, self.cfg.dataset.audio).cpu().numpy()
        if streaming_chunk > 0:
            raise NotImplementedError(
                "rtts_torch: streaming vocoding is not ported yet")
        gen = torch.Generator(device=self.device).manual_seed(0)
        audio = squeezewave.infer(self.vocoder, self.cfg.vocoder, mel_t[None],
                                  generator=gen)
        return audio[0].cpu().numpy()

    def __call__(self, texts: Sequence[str], seed: int = 0) -> List[np.ndarray]:
        mel, lengths = self.text_to_mel(texts, seed)
        return [self.mel_to_audio(mel[i], int(lengths[i]))
                for i in range(len(texts))]

    def _not_ported(self, *args, **kwargs):
        raise NotImplementedError(
            "rtts_torch: the variable-length serving surfaces are not ported "
            "yet")

    serve = serve_to_mel = serve_continuous = serve_continuous_to_mel = \
        _not_ported
