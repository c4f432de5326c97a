"""Benchmark harness of the port: ``rtts/bench.py`` on PyTorch and the card.

    python -m rtts_torch.bench [--config PATH|flagship|base]
                               [--which MODE|all] [--device cuda|cpu]

prints one JSON line per cell, in ``run_bench``'s format: ``metric``,
``value``, ``unit``, ``vs_baseline`` (the reference's formulas against the
north-star RTF target 0.05) and ``detail``.  The default is
``flagship_bench_config()`` and ``e2e``, as the JAX package's root
``bench.py``; the command line's ``bench`` verb runs the same cells.

Primary metrics, as in the reference: AR decode throughput (mel frames a
second, batched greedy decode) and the end-to-end text -> wav real-time
factor (RTF; target < 0.05).  The cells are ``bench_decode``,
``bench_e2e``, ``bench_vocoder``, ``bench_train_step``,
``bench_vocoder_train``, ``bench_longform``, ``bench_serving``,
``bench_continuous``, ``bench_latency`` and ``bench_kernels``, with the
reference's shapes, seeds of inputs, workloads and defaults.

Every cell runs on ``device="cuda"`` unless the caller passes
``device="cpu"`` (the tests do, at tiny configs: there every kernel
wrapper runs its plain version, and no number is a measurement of the
card).  Asked for the card on a host without one, a cell raises.

Timing.  A cell's wall is the host clock around work that ends in
``torch.cuda.synchronize()``, after one warm-up call that also builds the
kernels; it reports the best of ``repeats`` and, beside it under the same
name with ``_band`` appended, the band ``[min, max]`` of the repeats
(host-bound walls spread by a third within one process).  Kernel times
(``bench_kernels``) are CUDA events around a run of back-to-back launches,
divided by the count; no time comes from ``torch.profiler``, which keeps
fewer kernel records the older the process is.

FLOPs are counted from shapes (``rtts/bench.py`` reads XLA's cost
analysis, which has no counterpart here): a dense layer 2 rows d_in d_out,
a convolution 2 L C_in C_out K / groups, attention 4 b h L_q L_k d, the
causal self-attention of a train step the lower triangle L (L + 1) / 2 of
pairs that the algorithm needs (an LSH or local window is computed whole).
Elementwise work is not counted.  ``mfu`` is FLOPs / wall / the card's
peak dense bf16 rate (989e12 on an NVIDIA H100 80GB HBM3, the SXM part;
None on any other device, the CPU included, and None where the count is).

Each result names its device (``torch.cuda.get_device_name``) and the
card's power limit in watts (``power_limit_w``, from ``nvidia-smi``; None
where that fails), and ``resolved``: what the config resolved to at the
cell's shapes (attention kinds, residuals, FFN chunk, the decode cache).
``bench_kernels`` renames the reference's ``xla_ms``/``pallas_ms`` to
``plain_ms``/``kernel_ms`` and its headline ``pallas_vs_xla_min_speedup``
to ``cuda_vs_plain_min_speedup``, and adds each kernel's error against
its plain version run in f32 on the same inputs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rtts_torch.attention import lsh as TL
from rtts_torch.attention.full import (Attention, shared_keys,
                                       shared_qk_self_attention)
from rtts_torch.config import (Config, ReformerStackConfig,
                               ReformerTTSConfig, SqueezeWaveConfig,
                               from_dict, load_config, resolve_attention_kind,
                               resolve_ffn_chunk, resolve_reversible)
from rtts_torch.infer.decode import (_auto_mode, _auto_staged,
                                     _precast_weights, _stage_sizes,
                                     decode_greedy)
from rtts_torch.infer.serving import ServingEngine, serve_batch, serve_pool
from rtts_torch.infer.streaming import StreamingSynthesizer
from rtts_torch.models import reformer_tts as M
from rtts_torch.models import squeezewave as SW
from rtts_torch.models.reformer_tts import _dtype, _pad_multiple
from rtts_torch.models.stack import _layer_kinds
from rtts_torch.ops.chunked_ffn import chunked_ffn_fused, ffn_fused_reference
from rtts_torch.ops.depthwise_conv import (depthwise_conv1d,
                                           depthwise_conv1d_reference)
from rtts_torch.ops.flash_attention import (flash_attend,
                                            flash_attend_bwd_reference,
                                            flash_attend_reference)
from rtts_torch.ops.lsh_attention import (lsh_attend_bwd_reference,
                                          lsh_attend_chunks_kernel,
                                          lsh_attend_chunks_reference)
from rtts_torch.reversible.ffn import FFN
from rtts_torch.text import frontend_vocab_size, vocab_size
from rtts_torch.train import train_vocoder as VOC
from rtts_torch.train.losses import make_stop_target, tts_loss
from rtts_torch.train.optim import make_optimizer
from rtts_torch.train.train_tts import step_generator

TARGET_RTF = 0.05
# the cells of run_bench, in the command line's order
MODES = ("decode", "e2e", "vocoder", "train", "vocoder_train", "longform",
         "serving", "continuous", "latency", "kernels")
# peak dense bf16 FLOP/s by device name (NVIDIA's data sheet, SXM part)
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}
# bench_kernels' shapes, the reference's (rtts/bench.py::bench_kernels):
# LSH chunk attend (b, h, n_hashes, L, chunk, d) with one chunk before;
# fused LN + FFN (batch, rows, d, d_ff), gelu; depthwise conv (batch, L,
# C, taps); flash self-attention (b, L, d_model, heads), shared QK, causal
KERNEL_SHAPES = {"lsh": (8, 8, 4, 1024, 64, 64), "ffn": (8, 1024, 512, 2048),
                 "depthwise": (8, 1024, 128, 3), "flash": (8, 1024, 512, 8)}


def _frame_rate(cfg: Config) -> float:
    """Mel frames a second of real-time audio: sample_rate / hop."""
    return cfg.dataset.audio.sample_rate / cfg.dataset.audio.hop_length


# -- the device ---------------------------------------------------------------


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rtts_torch.bench: device 'cuda' asked for, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain versions on the CPU (no measurement of the card)")
    return dev


def _power_limit_w(dev: torch.device) -> Optional[float]:
    """The card's power limit in watts from ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader``, or None."""
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
        return float(out.strip().rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def _device_info(dev: torch.device) -> Dict[str, Any]:
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"device": name, "power_limit_w": _power_limit_w(dev)}


def _device_peak_flops(dev: torch.device) -> Optional[float]:
    if dev.type != "cuda":
        return None
    return PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(dev))


def _mfu(flops: Optional[float], seconds: float,
         dev: torch.device) -> Optional[float]:
    peak = _device_peak_flops(dev)
    if flops is None or peak is None or seconds <= 0:
        return None
    return flops / seconds / peak


# -- timing -------------------------------------------------------------------


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _walls(fn: Callable[[], Any], repeats: int, dev: torch.device,
           warmup: bool = True) -> List[float]:
    """Host-clock seconds of ``repeats`` calls of ``fn``, each ending in a
    synchronize, after one warm-up call (it also builds the kernels)."""
    if warmup:
        fn()
        _sync(dev)
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        out.append(time.perf_counter() - t0)
    return out


def _band(times: Sequence[float]) -> List[float]:
    return [min(times), max(times)]


def _per_call_ms(fn: Callable[[], Any], dev: torch.device, repeats: int,
                 iters: int = 32) -> float:
    """ms a call of ``fn``: CUDA events around ``iters`` back-to-back calls
    (the host clock on the CPU), the best of ``repeats`` runs, after a
    warm-up."""
    for _ in range(3):
        fn()
    _sync(dev)
    best = math.inf
    for _ in range(repeats):
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / iters
        best = min(best, ms)
    return best


# -- configs ------------------------------------------------------------------


def base_bench_config() -> Config:
    """The reference's BASELINE config 1: d_model 256, 4 + 4 layers, a
    reversible LSH encoder (4 hashes, chunk 64) and a reversible full
    causal decoder, bf16; batch-8 synthesis."""
    return from_dict(Config, {
        "model": {
            "vocab_size": vocab_size(),
            "d_model": 256,
            "n_mels": 80,
            "encoder": {"num_layers": 4, "d_model": 256, "d_ff": 1024,
                        "reversible": True, "causal": False,
                        "attention": {"kind": "lsh", "num_heads": 4,
                                      "head_dim": 64, "num_hashes": 4,
                                      "chunk_length": 64}},
            "decoder": {"num_layers": 4, "d_model": 256, "d_ff": 1024,
                        "reversible": True, "causal": True,
                        "attention": {"kind": "full", "num_heads": 4,
                                      "head_dim": 64, "num_hashes": 4,
                                      "chunk_length": 64}},
            "dec_prenet_hidden": 256,
            "max_pos": 4096,
            "compute_dtype": "bfloat16",
        },
    })


def flagship_bench_config() -> Config:
    """``configs/base.yaml``: d_model 512, 6 + 6 layers of 8 heads x 64,
    d_ff 2048, bf16.  At the bench's shapes (b8, 256 tokens, 512 frames;
    the train step's 512 frames) its ``auto`` knobs resolve to full
    softmax attention in both stacks (through K1; ``kind: auto`` keeps
    full attention to 32,768 positions), plain residuals (the reversible
    budget is not reached) and an unchunked FFN; the decode cache is
    ``kv_full``.  Each cell's ``resolved`` detail says so."""
    path = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
        "base.yaml"
    return load_config(str(path) if path.exists() else None,
                       [f"model.vocab_size={vocab_size()}"])


def longform_bench_config() -> Config:
    """The reference's BASELINE config 5: ``base_bench_config`` with 8192
    positions and an LSH decoder, so that 8k-frame synthesis exercises the
    LSH bucketing (256 buckets at L 8192) and the O(chunk) ring-buffer
    decode (``kv_lsh_chunk``)."""
    cfg = base_bench_config()
    model = dataclasses.replace(
        cfg.model, max_pos=8192,
        decoder=dataclasses.replace(
            cfg.model.decoder,
            attention=dataclasses.replace(cfg.model.decoder.attention,
                                          kind="lsh")))
    return dataclasses.replace(cfg, model=model)


def _with_vocab(cfg: Config) -> Config:
    """``run_bench``'s rule: a config without a vocabulary takes the
    frontend's for its text level."""
    if cfg.model.vocab_size > 0:
        return cfg
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, vocab_size=frontend_vocab_size(cfg.dataset.text.level)))


def _stack_resolved(cfg: ReformerStackConfig, batch: int, length: int,
                    mem_len: Optional[int] = None) -> Dict[str, Any]:
    kinds = [resolve_attention_kind(cfg.attention, length) if k == "auto"
             else k for k in _layer_kinds(cfg)]
    return {"attention": kinds,
            "reversible": resolve_reversible(cfg, batch, length, mem_len),
            "ffn_chunk": resolve_ffn_chunk(cfg, batch, length, mem_len),
            "fused_ffn": bool(cfg.use_pallas_ffn)}


def _resolved(cfg: Config, batch: int, token_len: int, frames: int,
              mode: Optional[str] = None) -> Dict[str, Any]:
    """What the config resolves to at a cell's shapes."""
    mcfg = cfg.model
    groups = frames // mcfg.reduction_factor
    out = {"encoder": _stack_resolved(mcfg.encoder, batch, token_len),
           "decoder": _stack_resolved(mcfg.decoder, batch, groups, token_len)}
    if mode is not None:
        out["decode_mode"] = (_auto_mode(mcfg, frames) if mode == "auto"
                              else mode)
    return out


# -- models and inputs --------------------------------------------------------


def _build(cfg: Config, dev: torch.device) -> M.ReformerTTS:
    return M.init(cfg.model, torch.Generator().manual_seed(0), dev)


def _serving_model(cfg: Config, dev: torch.device) -> M.ReformerTTS:
    """Random weights cast once to the compute dtype, as the serving
    surfaces cast them at load (``decode._precast_weights``)."""
    return _precast_weights(_build(cfg, dev), _dtype(cfg.model.compute_dtype))


def _vocoder(cfg: Config, dev: torch.device, seed: int) -> SW.SqueezeWave:
    return SW.fold_weightnorm(SW.init(cfg.vocoder,
                                      torch.Generator().manual_seed(seed),
                                      dev))


def _tokens(cfg: Config, n: int, token_len: int) -> np.ndarray:
    """Random ids in [3, vocab), drawn from a generator seeded 1."""
    g = torch.Generator().manual_seed(1)
    return torch.randint(3, cfg.model.vocab_size, (n, token_len),
                         generator=g).numpy()


def _on(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(dev)


def _encode_decode(model, cfg: Config, tokens: torch.Tensor,
                   mask: torch.Tensor, max_frames: int, **kw):
    """encode, then the greedy decode at stop threshold 2.0 (every request
    runs to its budget: stable timing), the prenet dropout drawn from a
    generator seeded 0."""
    with torch.no_grad():
        memory = M.encode(model, cfg.model, tokens, mask)
        gen = torch.Generator(device=tokens.device).manual_seed(0)
        return decode_greedy(model, cfg.model, memory, mask,
                             max_frames=max_frames, generator=gen,
                             stop_threshold=2.0, **kw)


# -- FLOPs, counted from shapes -----------------------------------------------


def _dense(rows: int, d_in: int, d_out: int) -> float:
    return 2.0 * rows * d_in * d_out


def _conv(rows: int, c_in: int, c_out: int, k: int, groups: int = 1) -> float:
    return 2.0 * rows * c_in * c_out * k / groups


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _window_attend(b: int, h: int, rows: int, keys: int, d: int) -> float:
    """QK and PV of ``rows`` query rows each against ``keys`` keys."""
    return 4.0 * b * h * rows * keys * d


def _self_attention_flops(cfg: ReformerStackConfig, kind: str, b: int, l: int,
                          triangle: bool) -> float:
    """One self-attention sublayer over (b, l): the projections and the
    core of its resolved kind.  ``triangle``: a causal full core counts
    the lower triangle (the train step), else all l x l pairs."""
    a = cfg.attention
    h, d, c = a.num_heads, a.head_dim, a.chunk_length
    f = 3 * _dense(b * l, cfg.d_model, h * d)            # w_qk, w_v, w_o
    if kind == "full" or l <= c:       # LSH and local fall back when short
        pairs = l * (l + 1) / 2 if triangle else l * l
        return f + 4.0 * b * h * pairs * d
    window = (a.num_chunks_before + 1 + a.num_chunks_after) * c
    if kind == "local":
        return f + _window_attend(b, h, l, window, d)
    nh = a.num_hashes
    nb = a.num_buckets or TL.auto_num_buckets(l, c)
    rot = sum([nb] if isinstance(nb, int) else nb) // 2
    f += 2.0 * b * h * l * d * nh * rot                  # the hash rotations
    if a.sort_gather == "onehot":      # gather and unsort as matmuls
        f += 2.0 * b * h * nh * l * l * 3 * d
    return f + _window_attend(b, h, nh * l, window, d)


def _ffn_flops(cfg: ReformerStackConfig, rows: int) -> float:
    return _dense(rows, cfg.d_model, cfg.d_ff) + _dense(rows, cfg.d_ff,
                                                        cfg.d_model)


def _stack_flops(cfg: ReformerStackConfig, b: int, l: int,
                 mem_len: Optional[int] = None, triangle: bool = False
                 ) -> float:
    """A stack over (b, l) inputs; with ``mem_len`` every layer also
    cross-attends to that many memory rows."""
    a = cfg.attention
    h, d = a.num_heads, a.head_dim
    f = 0.0
    for kind in _layer_kinds(cfg):
        if kind == "auto":
            kind = resolve_attention_kind(a, l)
        f += _self_attention_flops(cfg, kind, b, l,
                                   triangle and cfg.causal)
        f += _ffn_flops(cfg, b * l)
        if mem_len is not None:
            f += (2 * _dense(b * l, cfg.d_model, h * d)        # w_q, w_o
                  + 2 * _dense(b * mem_len, cfg.d_model, h * d)  # w_k, w_v
                  + _window_attend(b, h, l, mem_len, d))
            f += _ffn_flops(cfg, b * l)
    return f


def _encode_flops(mcfg: ReformerTTSConfig, b: int, token_len: int) -> float:
    """``reformer_tts.encode``: the prenet convs and the encoder stack on
    the tokens padded as ``_pad_multiple`` pads them."""
    l = _round_up(token_len, _pad_multiple(mcfg.encoder))
    d = mcfg.d_model
    f = mcfg.enc_prenet_layers * _conv(b * l, d, d, mcfg.enc_prenet_kernel)
    return f + _stack_flops(mcfg.encoder, b, l)


def _postnet_flops(mcfg: ReformerTTSConfig, b: int, frames: int) -> float:
    n, ch = mcfg.postnet_layers, mcfg.postnet_channels
    f = 0.0
    for i in range(n):
        c_in = mcfg.n_mels if i == 0 else ch
        c_out = mcfg.n_mels if i == n - 1 else ch
        f += _conv(b * frames, c_in, c_out, mcfg.postnet_kernel)
    return f


def _decode_buckets(mcfg: ReformerTTSConfig, n_groups: int) -> int:
    a = mcfg.decoder.attention
    return TL.total_buckets(a.num_buckets
                            or TL.auto_num_buckets(n_groups, a.chunk_length))


def _step_flops(mcfg: ReformerTTSConfig, b: int, token_len: int,
                cache_len: int, mode: str, n_groups: int) -> float:
    """One decode step (``decode._Decoder.step``) with its full caches
    ``cache_len`` positions long: a step reads every full cache whole,
    so the attention terms are linear in that length and the rest is
    constant."""
    dec, a = mcfg.decoder, mcfg.decoder.attention
    h, d, dm, nh = a.num_heads, a.head_dim, mcfg.d_model, a.num_hashes
    r_in = mcfg.n_mels * mcfg.reduction_factor
    f = (_dense(b, r_in, mcfg.dec_prenet_hidden)
         + _dense(b, mcfg.dec_prenet_hidden, dm))
    hash_f = 2.0 * b * h * d * nh * (_decode_buckets(mcfg, n_groups) // 2)
    ring = min(a.chunk_length * (1 + a.num_chunks_before
                                 + a.num_chunks_after), n_groups)
    for kind in _layer_kinds(dec):
        if kind == "auto":
            kind = resolve_attention_kind(a, n_groups)
        f += 3 * _dense(b, dm, h * d)                        # self
        if mode == "kv_local" and kind == "local":
            window = min(a.chunk_length * (1 + a.num_chunks_before), n_groups)
            f += 4.0 * b * h * window * d
        elif mode == "kv_lsh":
            f += hash_f + 2.0 * b * h * cache_len * d * (1 + nh) \
                + 2.0 * b * h * nh * d
        elif mode == "kv_lsh_chunk":
            f += hash_f + 2.0 * b * h * nh * d * (2 * ring + 1) \
                + 2.0 * b * h * nh * d
        else:
            f += 4.0 * b * h * cache_len * d
        f += 2 * _ffn_flops(dec, b)                          # both pairs' g
        f += 2 * _dense(b, dm, h * d) + 4.0 * b * h * token_len * d  # cross
    return f + _dense(b, dm, r_in) + _dense(b, dm, 1)        # mel, stop heads


def _decode_flops(cfg: Config, batch: int, token_len: int, max_frames: int,
                  mode: str = "kv_full", staged="auto",
                  stage_min: int = 128) -> float:
    """Encode + the cross-attention K/V of the memory + the AR decode +
    the postnet.  stop_threshold 2.0 runs every step.  ``staged`` as in
    ``decode_greedy``: a stage's steps read caches of the stage's length,
    so each stage's steps count at its size (the reference's assembly)."""
    mcfg = cfg.model
    if mode == "auto":
        mode = _auto_mode(mcfg, max_frames)
    n_groups = max_frames // mcfg.reduction_factor
    if staged == "auto":
        staged = _auto_staged(n_groups)
    sizes = _stage_sizes(n_groups, stage_min) if staged else (n_groups,)
    f_decode, prev = 0.0, 0
    for size in sizes:
        f_decode += (size - prev) * _step_flops(mcfg, batch, token_len, size,
                                                mode, n_groups)
        prev = size
    a = mcfg.decoder.attention
    f_mem = mcfg.decoder.num_layers * 2 * _dense(
        batch * token_len, mcfg.d_model, a.num_heads * a.head_dim)
    return (_encode_flops(mcfg, batch, token_len) + f_mem + f_decode
            + _postnet_flops(mcfg, batch, max_frames))


def _vocoder_flops(voc: SqueezeWaveConfig, batch: int,
                   mel_frames: int) -> float:
    """``squeezewave.infer`` (or ``forward``: the same convs and 1x1s) on
    ``mel_frames`` frames: per flow the WN's in/cond/depthwise/pointwise/
    res-skip/end convs and the invertible 1x1."""
    rows = batch * mel_frames * voc.hop_length // voc.n_group
    c, n = voc.wn_channels, voc.wn_layers
    f = 0.0
    for n_rem, _ in SW._channel_schedule(voc):
        half = n_rem // 2
        f += _dense(rows, half, c) + _dense(rows, voc.n_mels, 2 * c * n)
        f += n * (_conv(rows, c, c, voc.wn_kernel_size, groups=c)
                  + _dense(rows, c, 2 * c) + _dense(rows, c, c))
        f += _dense(rows, c, 2 * half) + _dense(rows, n_rem, n_rem)
    return f


def _train_flops(cfg: Config, batch: int, token_len: int,
                 mel_len: int) -> float:
    """One TTS train step: the teacher-forced forward (``forward``) and a
    backward counted as twice its matmul FLOPs, 3x in all (the optimizer
    and the loss are elementwise)."""
    mcfg = cfg.model
    r = mcfg.reduction_factor
    groups = -(-mel_len // r)
    g_pad = _round_up(groups, _pad_multiple(mcfg.decoder))
    r_in, hid, dm = mcfg.n_mels * r, mcfg.dec_prenet_hidden, mcfg.d_model
    f = _encode_flops(mcfg, batch, token_len)
    f += _dense(batch * g_pad, r_in, hid) + _dense(batch * g_pad, hid, dm)
    f += _stack_flops(mcfg.decoder, batch, g_pad, token_len, triangle=True)
    f += _dense(batch * groups, dm, r_in) + _dense(batch * groups, dm, 1)
    f += _postnet_flops(mcfg, batch, mel_len)
    return 3.0 * f


# -- decode-shaped cells ------------------------------------------------------


def bench_decode(cfg: Optional[Config] = None, batch: int = 8,
                 token_len: int = 256, max_frames: int = 512,
                 repeats: int = 3, mode: str = "kv_full", unroll: int = 1,
                 staged="auto", device="cuda") -> Dict[str, Any]:
    """Batched greedy AR decode throughput: mel frames/s on one card."""
    dev = _device(device)
    cfg = cfg or base_bench_config()
    model = _serving_model(cfg, dev)
    tokens = _on(_tokens(cfg, batch, token_len), dev)
    mask = torch.ones((batch, token_len), dtype=torch.bool, device=dev)
    times = _walls(lambda: _encode_decode(
        model, cfg, tokens, mask, max_frames, mode=mode, unroll=unroll,
        staged=staged), repeats, dev)
    dt = min(times)
    flops = _decode_flops(cfg, batch, token_len, max_frames, mode,
                          staged=staged)
    return {
        "frames_per_sec": batch * max_frames / dt,
        "decode_seconds": dt,
        "decode_seconds_band": _band(times),
        "batch": batch,
        "max_frames": max_frames,
        "mode": mode,
        "flops": flops,
        "mfu": _mfu(flops, dt, dev),
        **_device_info(dev),
        "resolved": _resolved(cfg, batch, token_len, max_frames, mode),
    }


def bench_e2e(cfg: Optional[Config] = None, batch: int = 8,
              token_len: int = 256, max_frames: int = 512,
              repeats: int = 3, use_vocoder: bool = True,
              mode: str = "auto", unroll: int = 1, staged="auto",
              device="cuda") -> Dict[str, Any]:
    """text -> wav RTF: wall / seconds of audio produced, on one card.
    mode="auto" is the Synthesizer's serving default, so the headline
    measures the shipped configuration."""
    dev = _device(device)
    cfg = cfg or base_bench_config()
    model = _serving_model(cfg, dev)
    voc = _vocoder(cfg, dev, 2) if use_vocoder else None
    tokens = _on(_tokens(cfg, batch, token_len), dev)
    mask = torch.ones((batch, token_len), dtype=torch.bool, device=dev)

    def run():
        mel = _encode_decode(model, cfg, tokens, mask, max_frames, mode=mode,
                             unroll=unroll, staged=staged).mel_post
        if voc is None:
            return mel                      # no vocoder: mel only
        with torch.no_grad():
            return SW.infer(voc, cfg.vocoder, mel, generator=torch.Generator(
                device=dev).manual_seed(0))

    times = _walls(run, repeats, dev)
    dt = min(times)
    audio_seconds = batch * max_frames / _frame_rate(cfg)
    flops = _decode_flops(cfg, batch, token_len, max_frames, mode,
                          staged=staged)
    if use_vocoder:
        flops += _vocoder_flops(cfg.vocoder, batch, max_frames)
    return {
        "rtf": dt / audio_seconds,
        "wall_seconds": dt,
        "wall_seconds_band": _band(times),
        "audio_seconds": audio_seconds,
        "batch": batch,
        "max_frames": max_frames,
        "mode": mode,
        "vocoder": bool(use_vocoder),
        "flops": flops,
        "mfu": _mfu(flops, dt, dev),
        **_device_info(dev),
        "resolved": _resolved(cfg, batch, token_len, max_frames, mode),
    }


def bench_longform(cfg: Optional[Config] = None, batch: int = 2,
                   token_len: int = 1024, max_frames: int = 8192,
                   repeats: int = 2, mode: str = "auto",
                   device="cuda") -> Dict[str, Any]:
    """Long-form batched text -> mel: an 8k-frame AR decode per utterance.
    mode="auto" routes the LSH decoder through the O(chunk) ring-buffer
    cache (kv_lsh_chunk): a step attends n_hashes x C keys, not the
    prefix."""
    cfg = cfg or longform_bench_config()
    r = bench_decode(cfg, batch=batch, token_len=token_len,
                     max_frames=max_frames, repeats=repeats, mode=mode,
                     device=device)
    r["rtf"] = r["decode_seconds"] / (batch * max_frames / _frame_rate(cfg))
    return r


# -- training and vocoder cells -----------------------------------------------


def bench_vocoder(cfg: Optional[Config] = None, batch: int = 8,
                  mel_frames: int = 512, repeats: int = 3,
                  device="cuda") -> Dict[str, Any]:
    """SqueezeWave ``infer`` (folded weights) on random mel."""
    dev = _device(device)
    cfg = cfg or base_bench_config()
    voc = cfg.vocoder
    model = _vocoder(cfg, dev, 0)
    mel = torch.randn((batch, mel_frames, voc.n_mels),
                      generator=torch.Generator().manual_seed(1)).to(dev)

    def run():
        with torch.no_grad():
            return SW.infer(model, voc, mel, generator=torch.Generator(
                device=dev).manual_seed(0))

    times = _walls(run, repeats, dev)
    dt = min(times)
    audio_seconds = batch * mel_frames * voc.hop_length / voc.sample_rate
    flops = _vocoder_flops(voc, batch, mel_frames)
    return {"vocoder_rtf": dt / audio_seconds, "wall_seconds": dt,
            "wall_seconds_band": _band(times),
            "audio_seconds": audio_seconds,
            "flops": flops, "mfu": _mfu(flops, dt, dev),
            **_device_info(dev)}


def bench_vocoder_train(cfg: Optional[Config] = None, batch: int = 8,
                        repeats: int = 3, device="cuda") -> Dict[str, Any]:
    """SqueezeWave train step (flow NLL forward, backward, clip, Adam) at
    the shipped crop length (``train_vocoder.make_train_step``)."""
    dev = _device(device)
    cfg = cfg or base_bench_config()
    voc = cfg.vocoder
    model = SW.init(voc, torch.Generator().manual_seed(0), dev)
    optimizer = make_optimizer(cfg.experiment.optim)
    state = optimizer.init(list(model.parameters()))
    seg = voc.audio_segment_length
    frames = seg // voc.hop_length
    batch_data = {
        "mel": torch.randn((batch, frames, voc.n_mels),
                           generator=torch.Generator().manual_seed(1)).to(dev),
        "audio": (torch.randn((batch, seg),
                              generator=torch.Generator().manual_seed(2))
                  * 0.1).to(dev),
    }
    step = VOC.make_train_step(voc, optimizer)
    times = _walls(lambda: step(model, state, batch_data), repeats, dev)
    dt = min(times)
    audio_seconds = batch * seg / voc.sample_rate
    flops = 3.0 * _vocoder_flops(voc, batch, frames)
    return {"vocoder_train_step_seconds": dt,
            "vocoder_train_step_seconds_band": _band(times),
            "audio_seconds_per_step": audio_seconds,
            "train_rtf": dt / audio_seconds,
            "flops": flops, "mfu": _mfu(flops, dt, dev),
            **_device_info(dev)}


def bench_train_step(cfg: Optional[Config] = None, batch: int = 8,
                     token_len: int = 256, mel_len: int = 512,
                     repeats: int = 3, device="cuda") -> Dict[str, Any]:
    """One TTS train step: the teacher-forced forward with dropout,
    ``tts_loss``, the backward and the optimizer (``make_optimizer``)."""
    dev = _device(device)
    cfg = cfg or base_bench_config()
    mcfg = cfg.model
    model = _build(cfg, dev)
    optimizer = make_optimizer(cfg.experiment.optim)
    params = list(model.parameters())
    state = optimizer.init(params)
    tokens = _on(_tokens(cfg, batch, token_len), dev)
    tmask = torch.ones((batch, token_len), dtype=torch.bool, device=dev)
    mel = torch.randn((batch, mel_len, mcfg.n_mels),
                      generator=torch.Generator().manual_seed(2)).to(dev)
    mmask = torch.ones((batch, mel_len), dtype=torch.bool, device=dev)
    calls = iter(range(repeats + 1))

    def step():
        gen = step_generator(3, next(calls), dev)
        pre, post, stop = M.forward(model, mcfg, tokens, tmask, mel, mmask,
                                    generator=gen)
        loss = tts_loss(pre, post, stop, mel, make_stop_target(mmask),
                        mmask)[0]
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        optimizer.step(params, grads, state)
        return loss

    times = _walls(step, repeats, dev)
    dt = min(times)
    flops = _train_flops(cfg, batch, token_len, mel_len)
    return {"train_step_seconds": dt,
            "train_step_seconds_band": _band(times),
            "frames_per_sec_train": batch * mel_len / dt,
            "flops": flops, "mfu": _mfu(flops, dt, dev),
            **_device_info(dev),
            "resolved": _resolved(cfg, batch, token_len, mel_len)}


# -- serving cells ------------------------------------------------------------


def bench_serving(cfg: Optional[Config] = None, repeats: int = 3,
                  mode: str = "auto", staged="auto", per_bucket: int = 32,
                  lengths: Sequence[int] = (128, 256, 512, 1024),
                  token_lens: Sequence[int] = (64, 64, 64, 128),
                  device="cuda") -> Dict[str, Any]:
    """Variable-length serving: bucketed batches against pad-to-max.

    ``per_bucket`` requests at each of ``lengths`` frames (stop threshold
    2.0 pins every request to its budget, so the comparison isolates shape
    management), with ``token_lens`` tokens.  Pad-to-max decodes all of
    them padded to the longest in one batch; bucketed serving decodes each
    bucket at its own max_frames.  The useful frames are the same."""
    dev = _device(device)
    cfg = cfg or base_bench_config()
    model = _serving_model(cfg, dev)
    lengths = list(lengths)

    def make_inputs(n, tl):
        return (_on(_tokens(cfg, n, tl), dev),
                torch.ones((n, tl), dtype=torch.bool, device=dev))

    def run(tok, msk, max_frames):
        return _encode_decode(model, cfg, tok, msk, max_frames, mode=mode,
                              staged=staged)

    bucket_inputs = {b: make_inputs(per_bucket, tl)
                     for b, tl in zip(lengths, token_lens)}
    base_inputs = make_inputs(per_bucket * len(lengths), max(token_lens))

    def bucketed():
        for b in lengths:
            run(*bucket_inputs[b], max_frames=b)

    def pad_to_max():
        run(*base_inputs, max_frames=max(lengths))

    bucketed()                  # warm every shape
    pad_to_max()
    _sync(dev)
    useful_frames = per_bucket * sum(lengths)
    t_serve, t_base = [], []
    for _ in range(repeats):
        t_serve += _walls(bucketed, 1, dev, warmup=False)
        t_base += _walls(pad_to_max, 1, dev, warmup=False)
    ts, tb = min(t_serve), min(t_base)
    return {
        "aggregate_frames_per_sec_bucketed": useful_frames / ts,
        "aggregate_frames_per_sec_pad_to_max": useful_frames / tb,
        "speedup": tb / ts,
        "bucketed_seconds": ts,
        "bucketed_seconds_band": _band(t_serve),
        "pad_to_max_seconds": tb,
        "pad_to_max_seconds_band": _band(t_base),
        "workload": {str(b): per_bucket for b in lengths},
        "mode": mode,
        **_device_info(dev),
        "resolved": _resolved(cfg, per_bucket * len(lengths),
                              max(token_lens), max(lengths), mode),
    }


def bench_continuous(cfg: Optional[Config] = None, repeats: int = 3,
                     per_group: int = 8, slots: int = 8,
                     segment_frames: int = 64,
                     lengths: Sequence[int] = (128, 256, 512, 1024),
                     token_len: int = 128, device="cuda") -> Dict[str, Any]:
    """Continuous batching against synchronous batches at the same
    concurrency.

    Scenario A: ``per_group`` requests at each of ``lengths`` frames (the
    budget stops each at its length), in a shuffled arrival order
    (``RandomState(0)``).  Five strategies, each decoding ``slots``
    requests at once: ``engine`` (``ServingEngine``: slot recycling in
    arrival order, the host drives segments; its per-request completion
    latency), ``fused`` (``serve_batch``: the whole queue in one host
    loop, one synchronization a boundary), ``pool`` (``serve_pool``: that
    per capacity class), ``pad_to_max`` (batches of ``slots`` in arrival
    order, each decoded to the longest length) and ``bucketed_oracle``
    (batches grouped by length, each at its own max_frames).  Scenario B:
    unpredictable stop times, lengths drawn in multiples of half the
    shortest length up to the longest; the fused scheduler against
    synchronous batches run to their longest member (in arrival order and
    sorted by length)."""
    dev = _device(device)
    cfg = cfg or base_bench_config()
    model = _serving_model(cfg, dev)
    lengths = list(lengths)
    rng = np.random.RandomState(0)
    workload = [l for l in lengths for _ in range(per_group)]
    rng.shuffle(workload)
    tokens_all = _tokens(cfg, len(workload), token_len).astype(np.int64)
    masks_all = np.ones((len(workload), token_len), bool)
    useful_frames = sum(workload)
    max_frames = max(lengths)

    eng = ServingEngine(cfg, model, slots=slots, capacity_frames=max_frames,
                        segment_frames=segment_frames, token_len=token_len,
                        stop_threshold=2.0, suppress_dispatch_warning=True)

    def run_engine():
        eng.reset()
        done_t = {}
        t0 = time.perf_counter()
        ids = [eng.submit_tokens(tokens_all[i:i + 1], masks_all[i:i + 1],
                                 budget_frames=true_len)
               for i, true_len in enumerate(workload)]
        while not eng.idle:
            for rid in eng.step():
                done_t[rid] = time.perf_counter()   # postnet in flight
        _sync(dev)
        wall = time.perf_counter() - t0
        eng.results.clear()
        lat = [done_t[r] - t0 for r in ids]
        return wall, float(np.mean(lat)), float(np.max(lat))

    def run_pool(budgets):
        t0 = time.perf_counter()
        # serve_pool reads every class's lengths: its work has finished
        serve_pool(model, cfg.model, tokens_all, masks_all, budgets,
                   class_caps=tuple(lengths), slots=slots,
                   segment_frames=segment_frames, stop_threshold=2.0, seed=0)
        return time.perf_counter() - t0

    tok_dev, msk_dev = _on(tokens_all, dev), _on(masks_all, dev)

    def run_fused(budgets):
        t0 = time.perf_counter()
        serve_batch(model, cfg.model, tok_dev, msk_dev,
                    _on(np.asarray(budgets, np.int64), dev),
                    capacity_frames=max_frames, slots=slots,
                    segment_frames=segment_frames, stop_threshold=2.0,
                    generator=torch.Generator(device=dev).manual_seed(0))
        _sync(dev)
        return time.perf_counter() - t0

    def run_sync(order, frame_caps):
        t0 = time.perf_counter()
        for start in range(0, len(order), slots):
            idx = order[start:start + slots]
            if len(idx) < slots:   # pad the tail batch to the slot count
                idx = (idx * ((slots // len(idx)) + 1))[:slots]
            _encode_decode(model, cfg, tok_dev[idx], msk_dev[idx],
                           frame_caps[start // slots], mode="auto")
        _sync(dev)
        return time.perf_counter() - t0

    arrival = list(range(len(workload)))
    pad_caps = [max_frames] * ((len(workload) + slots - 1) // slots)
    by_len = sorted(arrival, key=lambda i: workload[i])
    oracle_caps = [max(workload[i] for i in by_len[s:s + slots])
                   for s in range(0, len(by_len), slots)]

    run_engine()               # warm every path
    run_pool(workload)
    run_fused(workload)
    run_sync(arrival, pad_caps)
    run_sync(by_len, oracle_caps)
    eng_w, poo_w, fus_w, pad_w, ora_w = [], [], [], [], []
    lat_mean = lat_max = 0.0
    for _ in range(repeats):
        w, lat_mean, lat_max = run_engine()
        eng_w.append(w)
        poo_w.append(run_pool(workload))
        fus_w.append(run_fused(workload))
        pad_w.append(run_sync(arrival, pad_caps))
        ora_w.append(run_sync(by_len, oracle_caps))
    te, tl, tf, tp, to = (min(eng_w), min(poo_w), min(fus_w), min(pad_w),
                          min(ora_w))
    scenario_a = {
        "aggregate_frames_per_sec_pool": useful_frames / tl,
        "aggregate_frames_per_sec_fused": useful_frames / tf,
        "aggregate_frames_per_sec_engine": useful_frames / te,
        "aggregate_frames_per_sec_pad_to_max": useful_frames / tp,
        "aggregate_frames_per_sec_bucketed_oracle": useful_frames / to,
        "pool_speedup_vs_pad_to_max": tp / tl,
        "pool_speedup_vs_bucketed_oracle": to / tl,
        "fused_speedup_vs_pad_to_max": tp / tf,
        "fused_speedup_vs_bucketed_oracle": to / tf,
        "speedup_vs_pad_to_max": tp / te,
        "speedup_vs_bucketed_oracle": to / te,
        "pool_seconds": tl,
        "pool_seconds_band": _band(poo_w),
        "fused_seconds": tf,
        "fused_seconds_band": _band(fus_w),
        "engine_seconds": te,
        "engine_seconds_band": _band(eng_w),
        "pad_to_max_seconds": tp,
        "pad_to_max_seconds_band": _band(pad_w),
        "bucketed_oracle_seconds": to,
        "bucketed_oracle_seconds_band": _band(ora_w),
        "engine_latency_mean_s": lat_mean,
        "engine_latency_max_s": lat_max,
        "workload": {str(l): per_group for l in lengths},
    }

    # scenario B: every request predicts to the top class, but the true
    # lengths vary; synchronous batches run to their longest member
    # (charitably emulating the stop head firing, quantized), slot
    # recycling reclaims the steps the short requests do not use
    quantum = lengths[0] // 2
    n_b = len(lengths) * per_group
    true_b = (quantum * rng.randint(2, max_frames // quantum + 1,
                                    size=n_b)).tolist()
    useful_b = sum(true_b)

    def caps_for(order):
        return [quantum * (-(-max(true_b[i] for i in order[s:s + slots])
                             // quantum))
                for s in range(0, len(order), slots)]

    arrival_b = list(range(n_b))
    by_len_b = sorted(arrival_b, key=lambda i: true_b[i])
    run_fused(true_b)
    run_sync(arrival_b, caps_for(arrival_b))
    run_sync(by_len_b, caps_for(by_len_b))
    fus_b, arr_b, ora_b = [], [], []
    for _ in range(repeats):
        fus_b.append(run_fused(true_b))
        arr_b.append(run_sync(arrival_b, caps_for(arrival_b)))
        ora_b.append(run_sync(by_len_b, caps_for(by_len_b)))
    tfb, tab, tob = min(fus_b), min(arr_b), min(ora_b)
    scenario_b = {
        "aggregate_frames_per_sec_fused": useful_b / tfb,
        "aggregate_frames_per_sec_sync_arrival": useful_b / tab,
        "aggregate_frames_per_sec_sync_length_oracle": useful_b / tob,
        "fused_speedup_vs_sync_arrival": tab / tfb,
        "fused_speedup_vs_length_oracle": tob / tfb,
        "fused_seconds": tfb,
        "fused_seconds_band": _band(fus_b),
        "sync_arrival_seconds": tab,
        "sync_arrival_seconds_band": _band(arr_b),
        "sync_length_oracle_seconds": tob,
        "sync_length_oracle_seconds_band": _band(ora_b),
        "true_length_range": [min(true_b), max(true_b)],
        "n_requests": n_b,
    }
    return {
        "scenario_a_perfect_prediction": scenario_a,
        "scenario_b_unpredictable_lengths": scenario_b,
        "pool_speedup_vs_pad_to_max": scenario_a["pool_speedup_vs_pad_to_max"],
        "fused_speedup_vs_sync_arrival":
            scenario_b["fused_speedup_vs_sync_arrival"],
        "slots": slots,
        "segment_frames": segment_frames,
        **_device_info(dev),
        "resolved": _resolved(cfg, slots, token_len, max_frames, "auto"),
    }


def bench_latency(cfg: Optional[Config] = None,
                  concurrency: Tuple[int, ...] = (1, 8, 32),
                  repeats: int = 3,
                  chunk_sweep: Tuple[int, ...] = (32, 64, 128),
                  max_frames: int = 512,
                  lengths: Sequence[int] = (128, 256, 512),
                  token_len: int = 64, device="cuda") -> Dict[str, Any]:
    """Per-request latency and time to first audio.

    - ``batch`` / ``pool``: one call returns every request together, so
      each request's latency is the call's wall, per concurrency level
      (true lengths cycling through ``lengths``, stop pinned);
    - ``engine``: ``ServingEngine`` completes requests at segment
      boundaries: p50/p95 over the completion times;
    - ``streaming``: ``StreamingSynthesizer``'s time to first audio per
      ``chunk_frames`` at batch 1."""
    dev = _device(device)
    cfg = cfg or base_bench_config()
    model = _serving_model(cfg, dev)
    voc = _vocoder(cfg, dev, 2)
    lengths = list(lengths)
    hop = cfg.vocoder.hop_length
    sr = cfg.dataset.audio.sample_rate

    per_n: Dict[str, Any] = {}
    for n in concurrency:
        lens = [lengths[i % len(lengths)] for i in range(n)]
        tokens = _tokens(cfg, n, token_len).astype(np.int64)
        masks = np.ones((n, token_len), bool)
        tok_dev, msk_dev = _on(tokens, dev), _on(masks, dev)
        tb = _walls(lambda: _encode_decode(model, cfg, tok_dev, msk_dev,
                                           max_frames), repeats, dev)

        def run_p():
            mels, _ = serve_pool(model, cfg.model, tokens, masks, lens,
                                 class_caps=tuple(lengths), slots=min(8, n),
                                 stop_threshold=2.0, seed=0)
            return mels

        tp = _walls(run_p, repeats, dev)
        eng = ServingEngine(cfg, model, slots=min(8, n),
                            capacity_frames=max_frames, segment_frames=64,
                            token_len=token_len, stop_threshold=2.0,
                            suppress_dispatch_warning=True)

        def run_e():
            eng.reset()
            ids = [eng.submit_tokens(tokens[i:i + 1], masks[i:i + 1],
                                     budget_frames=lens[i])
                   for i in range(n)]
            done_t: Dict[int, float] = {}
            t0 = time.perf_counter()
            while len(done_t) < n:
                for rid in eng.step():
                    done_t[rid] = time.perf_counter() - t0
            eng.results.clear()
            return np.asarray([done_t[rid] for rid in ids])

        run_e()
        lats = np.stack([run_e() for _ in range(repeats)])
        best = lats.min(axis=0)   # per-request best of the repeats
        worst = lats.max(axis=0)
        per_n[str(n)] = {
            "lengths": lens,
            "batch_latency_s": min(tb),
            "batch_latency_band_s": _band(tb),
            "pool_latency_s": min(tp),
            "pool_latency_band_s": _band(tp),
            "engine_p50_s": float(np.percentile(best, 50)),
            "engine_p95_s": float(np.percentile(best, 95)),
            # the same statistic over the best and the worst repeat
            "engine_p95_band_s": [float(np.percentile(best, 95)),
                                  float(np.percentile(worst, 95))],
            "engine_drain_s": float(best.max()),
        }

    # streaming at batch 1; random weights would fire the stop head on
    # frame 1, so stop_threshold 2.0 runs every stream to max_frames
    ss = StreamingSynthesizer(
        dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, stop_threshold=2.0)),
        model, voc, max_frames=max_frames)
    text = ["speech synthesis latency probe sentence"]
    streaming: Dict[str, Any] = {}
    for ch in chunk_sweep:
        for _ in ss.stream(text, chunk_frames=ch, seed=0):
            pass                            # warm this chunk size
        ttfa, total, chunks = [], [], 0
        for _ in range(max(repeats, 5)):    # >= 5 repeats: the band needs mass
            t0 = time.perf_counter()
            first = None
            chunks = 0
            for _audio in ss.stream(text, chunk_frames=ch, seed=0):
                if first is None:
                    first = time.perf_counter() - t0
                chunks += 1
            ttfa.append(first)
            total.append(time.perf_counter() - t0)
        streaming[str(ch)] = {
            "ttfa_s": min(ttfa),
            "ttfa_band_s": _band(ttfa),
            "total_s": min(total),
            "total_band_s": _band(total),
            "n_chunks": chunks,
            # how far ahead of real time the first chunk lands
            "first_chunk_audio_s": ch * hop / sr,
        }
    return {
        "per_concurrency": per_n,
        "streaming_ttfa": streaming,
        "max_frames": max_frames,
        **_device_info(dev),
        "resolved": _resolved(cfg, max(concurrency), token_len, max_frames,
                              "auto"),
    }


# -- kernels ------------------------------------------------------------------


def _errors(got: Sequence[torch.Tensor],
            want: Sequence[torch.Tensor]) -> Dict[str, float]:
    """max |got - want| / max(|want|, 1) and max |got - want| over pairs."""
    scaled = absolute = 0.0
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs()
        scaled = max(scaled, (diff / w.float().abs().clamp_min(1.0))
                     .max().item())
        absolute = max(absolute, diff.max().item())
    return {"max_err": scaled, "max_abs_err": absolute}


def _entry(kernel, plain, dev, repeats, errors) -> Dict[str, Any]:
    """Times of ``kernel`` and ``plain`` (plain first), their speedup, and
    the kernel's errors against its plain version run in f32
    (``errors``)."""
    plain_ms = _per_call_ms(plain, dev, repeats)
    kernel_ms = _per_call_ms(kernel, dev, repeats)
    return {"plain_ms": plain_ms, "kernel_ms": kernel_ms,
            "speedup": plain_ms / kernel_ms, **errors}


def _grad_of(fn, *inputs, cotangent=None):
    """The gradients of ``fn(*inputs)`` with respect to each input, against
    ``cotangent`` (None: the gradients of the output's sum)."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    with torch.enable_grad():
        out = fn(*leaves)
        if cotangent is None:
            return torch.autograd.grad(out.float().sum(), leaves)
        return torch.autograd.grad(out, leaves, cotangent.to(out.dtype))


def _cotangent(like: torch.Tensor) -> torch.Tensor:
    """A cotangent of ``like``'s shape drawn from N(0, 1) and rounded to
    its dtype, as ``chip_smoke.py`` draws them."""
    return torch.randn(like.shape, generator=torch.Generator().manual_seed(9)
                       ).to(like.device, like.dtype)


def _lsh_inputs(shape, dev):
    """Chunk-attend inputs as the LSH pipeline makes them at
    ``KERNEL_SHAPES["lsh"]``: bf16 queries hashed into 2 L / c buckets and
    sorted by bucket (K7's path entry on the card), keys the length-
    normalised queries, every position valid."""
    b, h, nh, l, c, d = shape
    g = torch.Generator().manual_seed(0)
    qk = torch.randn((b, h, l, d), generator=g).to(dev, torch.bfloat16)
    v = torch.randn((b, h, l, d), generator=g).to(dev, torch.bfloat16)
    buckets = TL.hash_vectors(qk.float(), 2 * l // c, nh,
                              torch.Generator(device=dev).manual_seed(1),
                              None)
    sorted_pos, _, _ = TL._sort_by_bucket(buckets)
    nc = nh * l // c
    idx = sorted_pos.reshape(b, h, nh * l, 1).expand(b, h, nh * l, d)
    q_c = torch.gather(qk, 2, idx).reshape(b, h, nc, c, d)
    k_c = (q_c.float() / q_c.float().norm(dim=-1, keepdim=True).clamp_min(
        1e-6)).to(q_c.dtype)
    v_c = torch.gather(v, 2, idx).reshape(b, h, nc, c, d)
    pos_c = sorted_pos.reshape(b, h, nc, c)
    val_c = torch.ones((b, h, nc, c), dtype=torch.bool, device=dev)
    return (q_c, k_c, v_c), (pos_c, val_c, True, 1, 0)


def bench_kernels(repeats: int = 5, device="cuda",
                  shapes: Optional[Dict[str, tuple]] = None
                  ) -> Dict[str, Any]:
    """Each hand kernel against its plain PyTorch version at the flagship
    shapes (``KERNEL_SHAPES``), forward and forward + backward: K4 (+ K5),
    K6, K2 and K1 (+ K3).  speedup > 1 means the kernel wins.  Each entry
    also holds the kernel's error against its plain version run in f32 on
    the same inputs (the output forward, the input gradients forward +
    backward), as ``max_err`` (max |got - want| / max(|want|, 1)) and
    ``max_abs_err``."""
    dev = _device(device)
    shapes = {**KERNEL_SHAPES, **(shapes or {})}
    results: Dict[str, Any] = dict(_device_info(dev))
    bf16, f32 = torch.bfloat16, torch.float32

    # ---- LSH chunk attend (K4; K5 in the backward) --------------------------
    (q, k, v), opts = _lsh_inputs(shapes["lsh"], dev)
    fwd = (lambda q_, k_, v_: lsh_attend_chunks_kernel(q_, k_, v_, *opts)[0])
    ref = (lambda q_, k_, v_: lsh_attend_chunks_reference(q_, k_, v_,
                                                          *opts)[0])
    with torch.no_grad():
        errs = _errors([fwd(q, k, v)], [ref(q.float(), k.float(), v.float())])
    results["lsh_attend_fwd"] = _entry(
        lambda: fwd(q, k, v), lambda: ref(q, k, v), dev, repeats, errs)
    # the backward: K5 against its plain version in f32 on the same inputs
    with torch.no_grad():
        out, lse = lsh_attend_chunks_kernel(q, k, v, *opts)
    dout = _cotangent(out)
    want = lsh_attend_bwd_reference(
        q.float(), k.float(), v.float(), *opts[:2], dout.float(),
        torch.zeros_like(lse), *opts[2:])
    errs = _errors(_grad_of(fwd, q, k, v, cotangent=dout), want)
    results["lsh_attend_fwdbwd"] = _entry(
        lambda: _grad_of(lambda a: fwd(a, k, v), q),
        lambda: _grad_of(lambda a: ref(a, k, v), q), dev, repeats, errs)
    del q, k, v

    # ---- fused LN + FFN (K6), f32 multiplies as the reference's default -----
    b, rows, dm, dff = shapes["ffn"]
    ffn = FFN(dm, dff, generator=torch.Generator().manual_seed(4), device=dev)
    x = torch.randn((b, rows, dm), generator=torch.Generator().manual_seed(3)
                    ).to(dev)
    params = (ffn.ln.scale, ffn.ln.bias, ffn.w_in.w, ffn.w_in.b, ffn.w_out.w,
              ffn.w_out.b)
    fwd = (lambda xx: chunked_ffn_fused(ffn, xx, "gelu", f32))
    ref = (lambda xx: ffn_fused_reference(
        xx.reshape(-1, dm), *params, "gelu", f32).reshape(xx.shape))
    with torch.no_grad():
        errs = _errors([fwd(x)], [ref(x)])
        results["chunked_ffn_fwd"] = _entry(lambda: fwd(x), lambda: ref(x),
                                            dev, repeats, errs)
    dout = _cotangent(x)
    errs = _errors(_grad_of(fwd, x, cotangent=dout),
                   _grad_of(ref, x, cotangent=dout))
    results["chunked_ffn_fwdbwd"] = _entry(
        lambda: _grad_of(fwd, x), lambda: _grad_of(ref, x), dev, repeats,
        errs)
    del ffn, x, params

    # ---- depthwise conv1d (K2): SqueezeWave's WN stage ----------------------
    b, lsq, cch, taps = shapes["depthwise"]
    g = torch.Generator().manual_seed(5)
    xd = torch.randn((b, lsq, cch), generator=g).to(dev)
    wd = (torch.randn((taps, 1, cch), generator=g) * 0.1).to(dev)
    bd = torch.zeros((cch,), device=dev)
    with torch.no_grad():
        errs = _errors([depthwise_conv1d(xd, wd, bd)],
                       [depthwise_conv1d_reference(xd, wd, bd)])
        results["depthwise_conv_fwd"] = _entry(
            lambda: depthwise_conv1d(xd, wd, bd),
            lambda: depthwise_conv1d_reference(xd, wd, bd), dev, repeats,
            errs)
    del xd, wd, bd

    # ---- flash attention (K1; K3 in the backward): shared-QK causal self ----
    b, l, dm, heads = shapes["flash"]
    ap = Attention(dm, heads, dm // heads, shared_qk=True,
                   generator=torch.Generator().manual_seed(7), device=dev)
    xa = torch.randn((b, l, dm), generator=torch.Generator().manual_seed(8)
                     ).to(dev)

    def attn(impl):
        def f(xx):
            return shared_qk_self_attention(
                ap, xx, mask=None, causal=True, num_heads=heads,
                compute_dtype=bf16, impl=impl).to(xx.dtype)
        return f

    # the error: the kernels on the projected bf16 heads against the plain
    # version in f32 on the same heads
    with torch.no_grad():
        qk = ap.w_qk(xa, bf16).reshape(b, l, heads, -1).transpose(1, 2)
        vh = ap.w_v(xa, bf16).reshape(b, l, heads, -1).transpose(1, 2)
        kh = shared_keys(qk)
    kw = dict(causal=True, self_mask=True, sm_scale=1.0)
    k_fwd = (lambda a, b_, c: flash_attend(a, b_, c, **kw))
    k_ref = (lambda a, b_, c: flash_attend_reference(a, b_, c, **kw))
    with torch.no_grad():
        errs = _errors([k_fwd(qk, kh, vh)],
                       [k_ref(qk.float(), kh.float(), vh.float())])
    naive, flash = attn("naive"), attn("flash")
    with torch.no_grad():
        results["flash_attend_fwd"] = _entry(
            lambda: flash(xa), lambda: naive(xa), dev, repeats, errs)
    # the backward: K3 against its plain version in f32 on the same inputs,
    # K1's output and lse
    with torch.no_grad():
        out, lse = flash_attend(qk, kh, vh, return_lse=True, **kw)
    dout = _cotangent(out)
    want = flash_attend_bwd_reference(
        qk.float(), kh.float(), vh.float(), out.float(), dout.float(), lse,
        **kw)
    errs = _errors(_grad_of(k_fwd, qk, kh, vh, cotangent=dout), want)
    results["flash_attend_fwdbwd"] = _entry(
        lambda: _grad_of(flash, xa), lambda: _grad_of(naive, xa), dev,
        repeats, errs)
    return results


# -- entry points -------------------------------------------------------------


def run_bench(cfg: Optional[Config] = None, which: str = "e2e",
              device="cuda", **kwargs) -> str:
    """The one JSON line of cell ``which`` (``MODES``); ``kwargs`` go to
    the cell (its sizes: the tests run tiny ones on the CPU)."""
    cfg = _with_vocab(cfg or base_bench_config())
    kw = dict(kwargs, device=device)
    if which == "decode":
        r = bench_decode(cfg, **kw)
        line = {"metric": "mel_frames_per_sec_per_chip",
                "value": round(r["frames_per_sec"], 2), "unit": "frames/s",
                "vs_baseline": round(
                    r["frames_per_sec"] / (_frame_rate(cfg) / TARGET_RTF), 4),
                "detail": r}
    elif which == "e2e":
        r = bench_e2e(cfg, **kw)
        line = {"metric": "text_to_wav_rtf_per_chip",
                "value": round(r["rtf"], 5), "unit": "rtf",
                "vs_baseline": round(TARGET_RTF / r["rtf"], 4), "detail": r}
    elif which == "vocoder":
        r = bench_vocoder(cfg, **kw)
        line = {"metric": "vocoder_rtf", "value": round(r["vocoder_rtf"], 5),
                "unit": "rtf",
                "vs_baseline": round(TARGET_RTF / r["vocoder_rtf"], 4),
                "detail": r}
    elif which == "longform":
        # the 8k-frame scenario needs its own max_pos and decoder: the
        # caller's cfg is ignored, and the line says so
        r = bench_longform(**kw)
        r["config_note"] = "fixed longform_bench_config (caller cfg ignored)"
        line = {"metric": "longform_8k_decode_frames_per_sec",
                "value": round(r["frames_per_sec"], 2), "unit": "frames/s",
                "vs_baseline": round(TARGET_RTF / r["rtf"], 4), "detail": r}
    elif which == "train":
        r = bench_train_step(cfg, **kw)
        # multiples of real-time mel consumed a train second
        line = {"metric": "train_frames_per_sec", "unit": "frames/s",
                "value": round(r["frames_per_sec_train"], 2),
                "vs_baseline": round(
                    r["frames_per_sec_train"] / _frame_rate(cfg), 4),
                "detail": r}
    elif which == "vocoder_train":
        r = bench_vocoder_train(cfg, **kw)
        line = {"metric": "vocoder_train_rtf", "unit": "rtf",
                "value": round(r["train_rtf"], 5),
                "vs_baseline": round(1.0 / max(r["train_rtf"], 1e-9), 4),
                "detail": r}
    elif which == "serving":
        r = bench_serving(cfg, **kw)
        line = {"metric": "serving_bucketed_vs_pad_to_max_speedup",
                "value": round(r["speedup"], 4), "unit": "x",
                "vs_baseline": round(r["speedup"], 4), "detail": r}
    elif which == "continuous":
        r = bench_continuous(cfg, **kw)
        line = {"metric": "continuous_batching_vs_sync_speedup",
                "value": round(r["fused_speedup_vs_sync_arrival"], 4),
                "unit": "x",
                "vs_baseline": round(r["fused_speedup_vs_sync_arrival"], 4),
                "detail": r}
    elif which == "latency":
        r = bench_latency(cfg, **kw)
        ttfa = r["streaming_ttfa"].get("64") or next(
            iter(r["streaming_ttfa"].values()))
        line = {"metric": "streaming_time_to_first_audio_s",
                "value": round(ttfa["ttfa_s"], 4), "unit": "s",
                # > 1: the first chunk lands ahead of its own duration
                "vs_baseline": round(
                    ttfa["first_chunk_audio_s"] / ttfa["ttfa_s"], 4),
                "detail": r}
    elif which == "kernels":
        r = bench_kernels(**kw)
        speedups = {k: v["speedup"] for k, v in r.items()
                    if isinstance(v, dict) and "speedup" in v}
        worst = min(speedups, key=speedups.get)
        line = {"metric": "cuda_vs_plain_min_speedup",
                "value": round(speedups[worst], 4), "unit": "x",
                "vs_baseline": round(speedups[worst], 4),
                "worst_kernel": worst, "detail": r}
    else:
        raise ValueError(f"unknown bench {which!r}")
    return json.dumps(line)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m rtts_torch.bench",
        description="The port's benchmark cells; one JSON line each.")
    p.add_argument("--config", default="flagship",
                   help="a config YAML, or the name of a bench config: "
                        "flagship (flagship_bench_config(), "
                        "configs/base.yaml; the default) or base "
                        "(base_bench_config())")
    p.add_argument("--which", default="e2e", choices=list(MODES) + ["all"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    named = {"flagship": flagship_bench_config, "base": base_bench_config}
    cfg = (named[args.config]() if args.config in named
           else load_config(args.config))
    for mode in (MODES if args.which == "all" else [args.which]):
        print(run_bench(cfg, mode, device=args.device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
