"""ReformerTTS acoustic model: text -> mel (inference pieces).

Port of ``rtts/models/reformer_tts.py``: parameters (``init``), the encoder
(``encode``), the encoder prenet, the postnet and the autopad contract.  The
teacher-forced decoder (``decode_train``) comes with training; serving
decodes autoregressively in ``rtts_torch/infer/decode.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rtts_torch.config import AUTO_FFN_CHUNK, ReformerTTSConfig
from rtts_torch.models.stack import Stack, stack_apply
from rtts_torch.nn.conv import Conv1d
from rtts_torch.nn.layers import Dense, Embedding, LayerNorm, PrenetMLP
from rtts_torch.nn.posenc import ScaledPosEnc


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


class ConvLN(nn.Module):
    """One prenet/postnet layer: {conv, ln}."""

    def __init__(self, d_in: int, d_out: int, kernel: int, *, generator=None,
                 device=None):
        super().__init__()
        self.conv = Conv1d(d_in, d_out, kernel, generator=generator,
                           device=device)
        self.ln = LayerNorm(d_out, device=device)


class ReformerTTS(nn.Module):
    """Parameter tree of the acoustic model, named as the JAX pytree."""

    def __init__(self, cfg: ReformerTTSConfig, *, generator=None, device=None):
        super().__init__()
        if cfg.vocab_size <= 0:
            raise ValueError("cfg.vocab_size must be set (use "
                             "rtts_torch.text.frontend_vocab_size())")
        if cfg.pos_encoding != "scaled_sinusoidal":
            raise NotImplementedError(
                f"rtts_torch: pos_encoding {cfg.pos_encoding!r} is not ported")
        kw = dict(generator=generator, device=device)
        d = cfg.d_model
        self.embed = Embedding(cfg.vocab_size, d, **kw)
        self.enc_prenet = nn.ModuleList(
            ConvLN(d, d, cfg.enc_prenet_kernel, **kw)
            for _ in range(cfg.enc_prenet_layers))
        self.enc_pos = ScaledPosEnc(cfg.max_pos, d, device=device)
        self.encoder = Stack(cfg.encoder, cross_attend=False, **kw)
        self.dec_prenet = PrenetMLP(cfg.n_mels * cfg.reduction_factor,
                                    cfg.dec_prenet_hidden, d, **kw)
        self.dec_pos = ScaledPosEnc(cfg.max_pos, d, device=device)
        self.decoder = Stack(cfg.decoder, cross_attend=True, **kw)
        self.mel_head = Dense(d, cfg.n_mels * cfg.reduction_factor, **kw)
        self.stop_head = Dense(d, 1, **kw)
        n = cfg.postnet_layers
        self.postnet = nn.ModuleList(
            ConvLN(cfg.n_mels if i == 0 else cfg.postnet_channels,
                   cfg.n_mels if i == n - 1 else cfg.postnet_channels,
                   cfg.postnet_kernel, **kw)
            for i in range(n))


def init(cfg: ReformerTTSConfig, generator: Optional[torch.Generator] = None,
         device=None) -> ReformerTTS:
    """Random parameters with the reference's shapes and scales, drawn from
    ``generator`` (a CPU generator; seed it for reproducible weights)."""
    return ReformerTTS(cfg, generator=generator, device=device)


def _pad_multiple(cfg_stack) -> int:
    """Sequence-length divisor the stack requires (the autopad contract):
    kind lsh/local/auto pads to the chunk, ffn_chunk_size to its chunk —
    "auto" to AUTO_FFN_CHUNK, since chunking MAY engage."""
    a = cfg_stack.attention
    m = a.chunk_length if a.kind in ("lsh", "local", "auto") else 1
    c = cfg_stack.ffn_chunk_size
    if c == "auto":
        m = math.lcm(m, AUTO_FFN_CHUNK)
    elif c > 0:
        m = math.lcm(m, c)
    return m


def _autopad(x: torch.Tensor, mask: torch.Tensor, multiple: int):
    """Pad (B, L, ...) x and (B, L) mask with zeros along L to a multiple
    of ``multiple``.  Returns (x_pad, mask_pad, orig_len)."""
    l = x.shape[1]
    if multiple <= 1 or l % multiple == 0:
        return x, mask, l
    pad = multiple - l % multiple
    x = F.pad(x, [0, 0] * (x.ndim - 2) + [0, pad])
    mask = F.pad(mask, (0, pad))
    return x, mask, l


def encoder_prenet(layers, h: torch.Tensor, compute_dtype,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv -> LN -> relu per layer.  ``mask`` (B, L) re-zeroes pad
    positions before the first conv and after every layer, so the last
    valid positions do not depend on how much padding the batch has."""
    m = None if mask is None else mask[..., None].to(h.dtype)
    if m is not None:
        h = h * m
    for layer in layers:
        h = torch.relu(layer.ln(layer.conv(h, compute_dtype)))
        if m is not None:
            h = h * m.to(h.dtype)
    return h


def postnet_apply(layers, mel: torch.Tensor, compute_dtype,
                  frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Conv residual refiner: returns the residual to add to mel.
    ``frame_mask`` (B, T), when given, re-zeroes every layer beyond it."""
    h = mel
    n = len(layers)
    fm = None if frame_mask is None else frame_mask[..., None].to(mel.dtype)
    if fm is not None:
        h = h * fm
    for i, layer in enumerate(layers):
        h = layer.conv(h, compute_dtype)
        if i < n - 1:
            h = torch.tanh(layer.ln(h))
        if fm is not None:
            h = h * fm.to(h.dtype)
    return h


@torch.no_grad()
def encode(model: ReformerTTS, cfg: ReformerTTSConfig, tokens: torch.Tensor,
           token_mask: torch.Tensor) -> torch.Tensor:
    """tokens (B, L) int -> encoder memory (B, L, D), float32."""
    cdt = _dtype(cfg.compute_dtype)
    tokens, token_mask, orig_len = _autopad(
        tokens[..., None], token_mask.bool(), _pad_multiple(cfg.encoder))
    h = model.embed(tokens[..., 0], compute_dtype=cdt)
    h = encoder_prenet(model.enc_prenet, h, cdt, mask=token_mask)
    h = model.enc_pos(h)
    h = h * token_mask[..., None].to(h.dtype)
    out = stack_apply(model.encoder, cfg.encoder, h, token_mask,
                      compute_dtype=cdt)
    return out[:, :orig_len]
