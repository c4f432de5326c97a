"""ReformerTTS acoustic model: text -> mel.

Port of ``rtts/models/reformer_tts.py``: parameters (``init``), the encoder
(``encode``), the encoder prenet, the teacher-forced decoder
(``decode_train``, with reduction-factor grouping), the postnet, the
teacher-forcing shift and the full ``forward`` of the train step, with the
autopad contract.  Each takes an optional ``generator`` (on the model's
device): given one, the training dropouts are drawn from it; without one the
pass is deterministic, except the decoder prenet's dropout, which stays on
as in the reference (drawn from a generator seeded 1, the reference's fixed
key).  Serving decodes autoregressively in ``rtts_torch/infer/decode.py``.
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
from rtts_torch.nn.layers import (Dense, Embedding, LayerNorm, PrenetMLP,
                                  dropout)
from rtts_torch.nn.posenc import ScaledPosEnc


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def check_param_dtype(cfg) -> None:
    """Raise on a ``param_dtype`` other than float32, which the port does
    not build yet (the reference casts every parameter at init)."""
    if cfg.param_dtype != "float32":
        raise NotImplementedError(
            f"rtts_torch: param_dtype {cfg.param_dtype!r} is not ported yet "
            "(only 'float32')")


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
         device="cuda") -> ReformerTTS:
    """Random parameters with the reference's shapes and scales, drawn from
    ``generator`` (a CPU generator; seed it for reproducible weights), on
    ``device``: the card unless the caller asks for another (without a card
    the default raises).  Parameters are float32: any other
    ``param_dtype`` raises NotImplementedError."""
    check_param_dtype(cfg)
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
                   mask: Optional[torch.Tensor] = None, rate: float = 0.0,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """conv -> LN -> relu (-> dropout when ``generator`` is given) per
    layer.  ``mask`` (B, L) re-zeroes pad positions before the first conv
    and after every layer, so the last valid positions do not depend on how
    much padding the batch has."""
    m = None if mask is None else mask[..., None].to(h.dtype)
    if m is not None:
        h = h * m
    for layer in layers:
        h = torch.relu(layer.ln(layer.conv(h, compute_dtype)))
        if generator is not None:
            h = dropout(h, rate, generator)
        if m is not None:
            h = h * m.to(h.dtype)
    return h


def postnet_apply(layers, mel: torch.Tensor, compute_dtype,
                  frame_mask: Optional[torch.Tensor] = None, rate: float = 0.0,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Conv residual refiner: returns the residual to add to mel.
    ``frame_mask`` (B, T), when given, re-zeroes every layer beyond it;
    ``generator`` turns on the dropout after each tanh."""
    h = mel
    n = len(layers)
    fm = None if frame_mask is None else frame_mask[..., None].to(mel.dtype)
    if fm is not None:
        h = h * fm
    for i, layer in enumerate(layers):
        h = layer.conv(h, compute_dtype)
        if i < n - 1:
            h = torch.tanh(layer.ln(h))
            if generator is not None:
                h = dropout(h, rate, generator)
        if fm is not None:
            h = h * fm.to(h.dtype)
    return h


def encode(model: ReformerTTS, cfg: ReformerTTSConfig, tokens: torch.Tensor,
           token_mask: torch.Tensor,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """tokens (B, L) int -> encoder memory (B, L, D), float32.
    Differentiable; serving calls it under ``torch.no_grad()``."""
    cdt = _dtype(cfg.compute_dtype)
    tokens, token_mask, orig_len = _autopad(
        tokens[..., None], token_mask.bool(), _pad_multiple(cfg.encoder))
    h = model.embed(tokens[..., 0], compute_dtype=cdt)
    h = encoder_prenet(model.enc_prenet, h, cdt, mask=token_mask,
                       rate=cfg.enc_prenet_dropout, generator=generator)
    h = model.enc_pos(h)
    h = h * token_mask[..., None].to(h.dtype)
    out = stack_apply(model.encoder, cfg.encoder, h, token_mask,
                      compute_dtype=cdt, generator=generator)
    return out[:, :orig_len]


def decode_train(model: ReformerTTS, cfg: ReformerTTSConfig,
                 mel_input: torch.Tensor, mel_mask: torch.Tensor,
                 memory: torch.Tensor, memory_mask: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 attn_sink: Optional[list] = None):
    """Teacher-forced decoder pass -> (mel_pre, mel_post, stop_logits).

    mel_input (B, T, n_mels) is the shifted target (``shift_mel``).  With
    reduction factor r > 1 the decoder runs on groups of r frames.
    ``attn_sink`` collects each cross-attention layer's probabilities (B, H,
    T_groups_padded, L_tokens) f32 for the guided-attention loss."""
    cdt = _dtype(cfg.compute_dtype)
    r = cfg.reduction_factor
    orig_t = mel_input.shape[1]
    mel_mask = mel_mask.bool()
    frame_mask0 = mel_mask          # frame-rate mask, pre-grouping/pad
    if r > 1:
        pad = (-orig_t) % r
        if pad:
            mel_input = F.pad(mel_input, (0, 0, 0, pad))
            mel_mask = F.pad(mel_mask, (0, pad))
        b, tp, n = mel_input.shape
        mel_input = mel_input.reshape(b, tp // r, r * n)
        mel_mask = mel_mask.reshape(b, tp // r, r).any(-1)
    mel_input, mel_mask, orig_g = _autopad(mel_input, mel_mask,
                                           _pad_multiple(cfg.decoder))
    prenet_gen = generator
    if prenet_gen is None and cfg.dec_prenet_dropout > 0.0:
        prenet_gen = torch.Generator(device=mel_input.device).manual_seed(1)
    h = model.dec_prenet(mel_input.to(cdt), cfg.dec_prenet_dropout,
                         prenet_gen, compute_dtype=cdt)
    h = model.dec_pos(h)
    h = h * mel_mask[..., None].to(h.dtype)
    h = stack_apply(model.decoder, cfg.decoder, h, mel_mask, memory=memory,
                    memory_mask=memory_mask.bool(), compute_dtype=cdt,
                    generator=generator, attn_sink=attn_sink)
    h = h[:, :orig_g]
    mel_pre = model.mel_head(h, cdt).float()
    stop_logits = model.stop_head(h, cdt)[..., 0].float()
    if r > 1:
        b, g, _ = mel_pre.shape
        mel_pre = mel_pre.reshape(b, g * r, cfg.n_mels)[:, :orig_t]
        stop_logits = torch.repeat_interleave(stop_logits, r, dim=1)[:, :orig_t]
    residual = postnet_apply(model.postnet, mel_pre.to(cdt), cdt,
                             frame_mask=frame_mask0, rate=cfg.postnet_dropout,
                             generator=generator).float()
    return mel_pre, mel_pre + residual, stop_logits


def shift_mel(mel: torch.Tensor, reduction_factor: int = 1) -> torch.Tensor:
    """Teacher forcing input: prepend zero 'go' frame(s), drop the last;
    with r > 1 the input shifts by a whole group."""
    r = reduction_factor
    return torch.cat([torch.zeros_like(mel[:, :r]), mel[:, :-r]], dim=1)


def forward(model: ReformerTTS, cfg: ReformerTTSConfig, tokens: torch.Tensor,
            token_mask: torch.Tensor, mel_target: torch.Tensor,
            mel_mask: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            attn_sink: Optional[list] = None):
    """Full teacher-forced forward -> (mel_pre, mel_post, stop_logits)."""
    memory = encode(model, cfg, tokens, token_mask, generator)
    return decode_train(model, cfg, shift_mel(mel_target, cfg.reduction_factor),
                        mel_mask, memory, token_mask, generator,
                        attn_sink=attn_sink)
