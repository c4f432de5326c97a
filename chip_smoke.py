#!/usr/bin/env python3
"""Smoke run of the rtts_torch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's paths at full width with random weights made from fixed
seeds: serving at ``configs/base.yaml``
(``rtts_torch.infer.synthesize.Synthesizer``: text -> encoder -> kv_full
greedy decode -> postnet -> SqueezeWave inverse), TTS training at
``configs/base.yaml`` (``rtts_torch.train.train_tts.make_train_step``:
teacher-forced forward with dropout, loss with guided attention, backward,
clip, Adam, Noam), TTS training with LSH attention at
``configs/longform_8k.yaml``, reversible TTS training with the chunked
FFN and K6 at ``configs/serving_fast.yaml``, vocoder training at
``configs/base.yaml`` (``rtts_torch.train.train_vocoder``), the audio
frontend (Griffin-Lim, log-mel, denoiser), and serving in every decode
cache at ``configs/longform_8k.yaml`` (kv_lsh_chunk),
``configs/serving_fast.yaml`` (e4m3 caches, staged) and
``configs/parity_local.yaml`` (local attention, kv_local; its training
too), and the serving surfaces (continuous batching, bucketed serve,
streaming) at ``configs/base.yaml``, phase by phase; every phase raises on
failure:

1. device: the card's name and power limit;
2. build: nvcc builds the CUDA kernels from ``rtts_torch/csrc``;
3. kernels: K1 (flash-attention forward; bf16 on tensor cores) and K2
   (depthwise conv) on the card against their plain PyTorch versions, at
   the serving shapes (K2 also with the vocoder's f32 weight and bias read
   by the kernel); K2's ``autograd.Function`` backward against the plain
   conv's autograd, and a backward through one full-width WN giving every
   depth stage the plain conv's gradient;
4. slice: the Synthesizer answers 8 sentences with finite waveforms of the
   expected lengths, through both kernels (launch counters), and the same
   weights and noise at float32 on the card match the port on the CPU;
5. timing at the shape of ``rtts/bench.py::bench_e2e`` (batch 8, 256 tokens,
   512 frames, stop threshold 2.0, batched vocoder), and each kernel
   against its plain version: K1 at the encoder's shape, K2 at the batched
   vocoder's (8, 1024, 128) and the serving path's (1, 1024, 128), in turns
   with ``F.conv1d(groups=128)``;
6. profile: ``torch.profiler`` over a 64-frame decode at that shape, for
   the device's busy and idle share, the kernels per decode step and the
   ops that take the device time;
7. kernels-train: K1 with dropout and its lse, and K3 (the dK/dV and dQ
   kernels; both bf16 paths on tensor cores), against their plain versions
   at the training shapes (base.yaml's and the longform decoder's
   cross-attention, 8192 x 1024), in bf16 and f32, at dropout 0 and 0.1;
   the kernels' keep masks against
   ``dropout_keep_mask`` bit for bit;
8. train slice: three train steps at base.yaml (batch 8, ragged lengths up
   to 256 tokens and 1024 frames, bf16) with finite loss, grad norm and
   gradients, 12 launches of K1 and of each K3 kernel per step; then one
   step with attention dropout 0.1;
9. train card-vs-CPU: one float32 train step at 2 + 2 layers on the card
   (kernels) and on the CPU (plain versions) from the same weights and
   batch: loss, every gradient and the parameters after the update;
10. train timing: the step at batch 8 x 1024 frames (best of 3), a
   ``torch.profiler`` view of one step, and K1 (with lse) and K3 against
   their plain versions at the decoder and encoder shapes (K3 bf16 on
   tensor cores);
11. kernels-lsh: K4 (LSH chunk-attend; bf16 on tensor cores) and K5 (its
   backward: a dQ kernel per query chunk, a dK/dV kernel per key chunk;
   bf16 on tensor cores) against their plain versions at four longform
   shapes (the decoder's b2
   h8 4 hashes L8192, the encoder's L1024, a ragged one, one whose chunk
   count is not a multiple of 8), a window of one chunk on each side
   (before 1, after 1) and serving_fast.yaml's two (b8: the decoder's
   L1024 causal, the encoder's L256, both ragged), bf16 and f32; K4 and
   K5 twice, bit-equal;
12. LSH train slice: three longform_8k.yaml steps at full width (batch 2,
   ragged up to 1024 tokens and 8192 frames, bf16): finite loss, grad norm
   and gradients; per step 12 launches of K4, K5 and K7's path entry (the
   bucket sort) and 6 of K1 and each K3 kernel; K4's and K7's launches
   counted by shape;
13. LSH train card-vs-CPU: one float32 step at 2 + 2 layers from the same
   weights, batch and rotations: the share of equal buckets, then loss,
   every gradient and the parameters after the update;
14. LSH train timing: the step at batch 2 x 8192 frames (best of 3), a
   ``torch.profiler`` view of one step, K4 and K5 against their plain
   versions and bounds, the plain attend against K4 + K5, and K1 and K3
   at the cross-attention's shape against their plain versions and bounds,
   with ``F.scaled_dot_product_attention`` there as the yardstick: its
   forward alone against K1, forward + backward against K1 + K3; the
   registers, spill, shared memory and blocks an SM that the runtime
   reports of K4's, K5's and K1's bf16 kernels;
15. kernels-ffn: K6 (fused LN + FFN; bf16 multiplies on tensor cores)
   against its plain version at the decoder's (8 x 1024 rows, 512 -> 2048)
   and encoder's (8 x 256) FFN shapes, a ragged row count and a narrow
   width with each activation, multiplying in bf16 and f32, with the rows
   a block it takes; twice, bit-equal;
16. reversible train slice: three ``configs/serving_fast.yaml`` steps at
   full width (reversible residuals, LSH in both stacks, batch 8, ragged
   up to 256 tokens and 1024 frames, bf16) with K6 on every FFN: finite
   loss, grad norm and nonzero gradients, per step 36 launches of K6, 24
   of K4 and of K7's path entry (forward and recompute), 12 of K5, 12 of
   K1 and 6 of each K3 kernel, K4's, K6's and K7's counted by shape; then
   three steps as shipped (the chunked FFN), with no K6 launch;
17. reversible card-vs-CPU: one float32 step at 2 + 2 layers, the card
   with K6, the CPU with its plain version, buckets counted; then
   reversible against plain residuals on the card with dropout on;
18. reversible timing: the step at batch 8 x 1024 frames (best of 3, peak
   device memory) for reversible + K6, reversible + the chunked FFN,
   reversible with an unchunked FFN and plain residuals with an unchunked
   FFN, each with a ``torch.profiler`` view of one step; every reversible
   peak below 0.6 of the plain one; what autograd holds after one FFN
   sublayer's forward, chunked below unchunked; K6 at the decoder's and
   encoder's FFN against its plain version, its bound and the unfused
   bf16 FFN (a yardstick: F.layer_norm, bf16 torch.matmul, the
   activation, bf16 torch.matmul), with the runtime's resources of its
   kernels; K4 at serving_fast's two LSH shapes against its plain version
   and bound; each with its launches a step;
19. kernels-sort: K7's path entry (the LSH bucket sort) against its plain
   version at the LSH train steps' four bucket shapes, lengths that are
   not a power of two and the most keys, with padded rows; K7's column
   entry (bitonic column sort) and K8 (row gather) against their plain
   versions and ``torch.sort`` / ``index_select``; all exactly, twice
   bit-equal; the column entry and K8 at the sort probe's shapes (its own,
   longform_8k's and serving_fast's LSH keys and packed gathers), a wide
   tile, the most rows, narrow rows of 10 and 12 bytes and 200-byte bf16
   rows;
20. sort probe: ``rtts_torch.probes.probe_vmem_sort.bench()`` (K7 and K8
   against the library calls and the LSH path's own sort and gather, the
   one-hot permutation, the two ``sort_gather`` modes, the sort/gather
   share of a longform and a serving_fast train step, the verdict), with
   the launch counts of K7 and K8 read around it; then
   ``lsh_attention_core`` with ``sort_gather: onehot`` against ``take`` at
   serving_fast's shape, forward and backward, f32 and bf16; then K7's path
   entry at the four bucket shapes against its plain version, one
   ``torch.sort`` and its bound, and one CTA a row against a 2-CTA cluster
   a row on 64 rows of 1024 to 32768 keys;
21. kernels-vocoder-train: K2 at the vocoder train step's shape (8, 128,
   128), 3 taps, bf16 x with f32 w/b and f32, against its plain version,
   twice bit-equal, and its ``autograd.Function``'s three gradients
   against the plain conv's autograd;
22. vocoder train slice: three ``base.yaml`` vocoder steps at full width
   (``rtts_torch.train.train_vocoder.make_train_step``: flow NLL, backward
   through K2's Function, clip, Adam, Noam; batch 8 x 16384 samples,
   random mel and audio x 0.1, bf16): finite loss, grad norm and
   gradients, every gradient nonzero at step 3, 96 K2 launches per step;
   one eval step and one ``infer`` on the batch's mel, 96 each; one step
   at ``flagship.yaml``'s vocoder settings (f32, ``log_s_clamp`` 5.0);
   then ``train_vocoder`` on a corpus of random ``.rclip`` clips the phase
   writes: 4 steps with evals at 2 and 4 (``val/mr_stft`` finite, the wav
   artifacts written, checkpoints), a resume to 6 whose last metrics
   equal 6 steps in one run;
23. vocoder train card-vs-CPU: one f32 step at reduced depth (5 flows,
   early emission every 2, 32 groups, 2 WN layers x 32 channels, "end"
   live, ``log_s_clamp`` 2.0) on the card (K2) and the CPU (its plain
   version): the metrics, every gradient and the parameters after the
   update;
24. vocoder train timing: the step at b8 x 16384 (best of 3, peak memory,
   host synchronizations by CUDA's sync debug mode), a ``torch.profiler``
   view of one step with slogdet's share, slogdet of the 12 1x1 weights
   alone, K2 at (8, 128, 128) against its plain version, ``F.conv1d`` and
   its bound, and the Function's backward;
25. audio: the Synthesizer without a vocoder answers a sentence through
   Griffin-Lim on the card; Griffin-Lim from one angle and the log-mel on
   the card against the CPU, the log-mel's matmul DFT against
   ``torch.fft``; the denoiser on a vocoded utterance, card against CPU;
26. serving-longform: ``longform_8k.yaml`` as ``rtts/bench.py::
   bench_longform`` shapes it, b2 x 1024 random tokens x 8192 frames,
   mode "auto" (asserted to resolve kv_lsh_chunk), stop threshold 2.0:
   the encoder's K4 and K7 launches (6 each), decode frames/s, a profile
   of 64 steps at group 4096 (idle share), and the per-step time of
   kv_lsh_chunk against kv_full at groups 1024, 4096 and 8191 with caches
   filled from a seed, in turns;
27. serving-fast: ``serving_fast.yaml`` as shipped (kv_full, e4m3,
   staged): the Synthesizer answers 8 sentences (K4, K7 at the encoder, K2
   at the vocoder); then b8 x 256 tokens x 1024 frames with the e4m3 and
   the compute-dtype cache, staged and not, in turns: frames/s, the
   relative mel L1 of e4m3 against compute, staged against not;
28. parity-local: K4/K5 on ``parity_local.yaml``'s local layers (b8 h4,
   8 chunks of 32, causal) against the f32 plain attend, forward and
   backward, bf16 and f32; the Synthesizer in kv_local ("auto"); b8 x 512
   frames in kv_local and kv_full (frames/s); three bf16 train steps at
   full width with K4/K5 launches by shape (2 of each a step on the local
   layers); one f32 step at 2 + 2 layers ([local, lsh]) card vs CPU,
   buckets counted as in phase 13; K4 and K5 at the local shape against
   their plain versions and bounds;
29. decode-syncs: kv_lsh_chunk, kv_lsh (longform), kv_full with e4m3,
   staging and unroll 4 (serving_fast), kv_local with ``attn_window``
   (parity_local): three steps each under CUDA's sync debug mode "error",
   and a whole 64-group decode synchronizing exactly once per ``unroll``
   steps (the stop check);
30. serving: ``base.yaml`` at full width (prenet dropout off, stop 2.0)
   on ``rtts/bench.py``'s serving workloads: (a) ``Synthesizer.
   serve_continuous(vocode="batched")`` on 32 requests of 128/256/512/1024
   frames in ``bench_continuous``'s arrival order, 8 slots, segments of
   64 (32 waveforms of their lengths, at most one host synchronization a
   boundary beside one lengths read and one audio copy a class, K1 and
   K2 launches); (b) ``ServingEngine`` on the same requests (frames/s,
   p50/p95 completion latency, lengths equal and mel L1 against (a)); (c)
   bucketed ``serve`` against pad-to-max ``text_to_mel`` at 1024 frames
   (frames/s, mel L1); (d) ``StreamingSynthesizer`` at batch 1 x 512
   frames in chunks of 32, 64, 128 (time to first audio, at most one
   synchronization a segment and one for the tail, the decoded frames
   equal to ``decode_greedy``'s step loop bit for bit); (f)
   ``mel_to_audio(streaming_chunk=64)`` against one pass; K1 and K2 at the
   path's shapes; (e) ``serve_batch`` f32 at 2 + 2 layers, card vs CPU;
   (g) ``serve_pool`` at ``serving_fast.yaml`` as shipped (e4m3 rings,
   K4/K7 at the encoder) on 8 x 256 frames.

Prints a JSON line of per-kernel results, each entry at one shape (K1 at
three: ``flash`` at serving, ``flash_train`` at base.yaml's decoder,
``flash_cross`` at the longform cross-attention; K7 at two:
``sort_by_bucket``, its path entry, at the longform decoder's buckets,
``bitonic_sort``, its column entry, at the probe's longform keys; K2 at
two: ``depthwise`` at serving, ``depthwise_train`` in vocoder training;
K4 and K5 also at parity_local's local layers, ``lsh_attend_local`` and
``lsh_attend_bwd_local``, with the launches of phase 28's train steps; K1
and K2 again on the continuous path, ``flash_serve`` and
``depthwise_serve``, with the launches of phase 30(a)):
time by
the events loop,
device time from ``torch.profiler``'s kernel events, plain time, bound,
library time where one PyTorch call computes the same function, launches
on the main path; and, last, the JSON result line.
Exits non-zero, printing no result, without a CUDA GPU.  Imports only the
port: no JAX and nothing of the JAX package (PyYAML is not needed either:
the configs are the dicts below).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import pathlib
import re
import shutil
import struct
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from rtts_torch.attention import lsh as TL
from rtts_torch.audio.griffin import _griffin_lim_from_angle
from rtts_torch.audio.stft import log_mel_spectrogram
from rtts_torch.config import AttentionConfig, Config, from_dict
from rtts_torch.infer import decode as TD
from rtts_torch.infer.decode import decode_greedy
from rtts_torch.infer.denoiser import Denoiser, denoise
from rtts_torch.infer.serving import ServingEngine, serve_batch, serve_pool
from rtts_torch.infer.streaming import StreamingSynthesizer
from rtts_torch.infer.synthesize import Synthesizer
from rtts_torch.models import reformer_tts as M
from rtts_torch.models import squeezewave as SW
from rtts_torch.models import stack as TS
from rtts_torch.ops import _build
from rtts_torch.ops import bitonic_sort as BS
from rtts_torch.ops import chunked_ffn as CF
from rtts_torch.ops import lsh_attention as LA
from rtts_torch.ops.bitonic_sort import (MAX_ROWS, bitonic_sort_cols,
                                         bitonic_sort_cols_reference,
                                         sort_by_bucket,
                                         sort_by_bucket_reference)
from rtts_torch.ops.chunked_ffn import ffn_fused, ffn_fused_reference
from rtts_torch.ops.depthwise_conv import (depthwise_conv1d,
                                           depthwise_conv1d_reference)
from rtts_torch.ops.flash_attention import (dropout_keep_mask, flash_attend,
                                            flash_attend_bwd_reference,
                                            flash_attend_reference,
                                            flash_bwd_dkv, flash_bwd_dq,
                                            flash_fwd)
from rtts_torch.ops.lsh_attention import (lsh_attend_bwd,
                                          lsh_attend_bwd_reference,
                                          lsh_attend_chunks_kernel,
                                          lsh_attend_chunks_reference,
                                          lsh_attend_fwd)
from rtts_torch.ops.row_gather import row_gather, row_gather_reference
from rtts_torch.probes import probe_vmem_sort as probe
from rtts_torch.nn.layers import activation
from rtts_torch.reversible.ffn import FFN, chunked_ffn
from rtts_torch.text import encode_batch, frontend_vocab_size
from rtts_torch.train.optim import make_optimizer
from rtts_torch.train.train_tts import make_train_step, step_generator
from rtts_torch.train.train_vocoder import make_eval_step as \
    make_vocoder_eval_step
from rtts_torch.train.train_vocoder import make_train_step as \
    make_vocoder_train_step
from rtts_torch.train.train_vocoder import train_vocoder

# configs/base.yaml as a dict (tests/test_torch_guards.py holds the two equal)
_STACK_ATTENTION = {"kind": "auto", "num_heads": 8, "head_dim": 64,
                    "num_hashes": 4, "chunk_length": 64,
                    "num_chunks_before": 1}
BASE_CONFIG = {
    "dataset": {"data_dir": "data", "batch_size": 8, "num_workers": 4,
                "max_mel_len": 1024},
    "model": {
        "d_model": 512,
        "n_mels": 80,
        "guided_attention_weight": 2.0,
        "guided_attention_decay_steps": 75000,
        "encoder": {"num_layers": 6, "d_model": 512, "d_ff": 2048,
                    "ffn_chunk_size": "auto", "reversible": "auto",
                    "causal": False, "attention": dict(_STACK_ATTENTION)},
        "decoder": {"num_layers": 6, "d_model": 512, "d_ff": 2048,
                    "ffn_chunk_size": "auto", "reversible": "auto",
                    "causal": True, "attention": dict(_STACK_ATTENTION)},
        "compute_dtype": "bfloat16",
    },
    "vocoder": {"n_flows": 12, "n_group": 128, "n_early_every": 4,
                "n_early_size": 16, "wn_layers": 8, "wn_channels": 128},
    "experiment": {"max_steps": 100000,
                   "optim": {"learning_rate": 2.0e-4, "warmup_steps": 4000,
                             "schedule": "noam", "grad_clip_norm": 1.0}},
}

SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "Printing, in the only sense with which we are at present concerned.",
    "She sells sea shells by the sea shore.",
    "A journey of a thousand miles begins with a single step.",
    "The museum opens at nine in the morning on weekdays.",
    "Please call Stella and ask her to bring these things with her.",
    "How much wood would a woodchuck chuck if a woodchuck could chuck wood?",
    "It was the best of times, it was the worst of times.",
]

# kernel vs plain version: max |kernel - plain| / max(1, |plain|).  f32: the
# kernels sum in another order than the plain versions (and expf vs
# torch.exp differ in the last ulps); bf16: both round nearly the same f32
# value, so they are at most one bf16 ulp (2^-7 relative) apart.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# float32 on the card vs float32 on the CPU over encode + 64 decode steps +
# vocoder: same algorithm, other summation orders (cuBLAS vs the CPU BLAS,
# K1's online softmax) compounded through the autoregressive loop
SLICE_TOL = 1e-3

# one f32 train step, card vs CPU, 2 + 2 layers: loss and each gradient
# leaf relative to its largest entry (cuBLAS vs the CPU BLAS and the
# kernels' summation order, through forward and backward); the parameters
# after one Adam update within 3 lr: Adam moves every entry by about
# +-lr, so a gradient of rounding-noise size may flip its step
TRAIN_SLICE_TOL = 1e-3
TRAIN_PARAM_TOL_LR = 3.0

SEED_TTS, SEED_VOC, SEED_END, SEED_DATA, SEED_TRAIN = 0, 1, 2, 3, 4
DROP_SEED = 0x9E3779B9


def _scaled_err(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()


def _rel_err(got, want) -> float:
    """max |got - want| / max |want|: the error against the signal's scale."""
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


def _abs_err(got, want) -> float:
    return (got.float().cpu() - want.float().cpu()).abs().max().item()


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def base_config(compute_dtype: str = "bfloat16", **model_overrides) -> Config:
    """base.yaml with the vocabulary size set, one compute dtype for the
    acoustic model and the vocoder, and ``model_overrides``."""
    data = copy.deepcopy(BASE_CONFIG)
    data["model"].update(vocab_size=frontend_vocab_size("char"),
                         compute_dtype=compute_dtype, **model_overrides)
    data["vocoder"]["compute_dtype"] = compute_dtype
    return from_dict(Config, data)


def build_models(cfg: Config, device):
    """Seeded random TTS model and folded vocoder.  The vocoder's zero-init
    "end" convs get small random values, so its WN path (and K2) reaches
    the audio."""
    tts = M.init(cfg.model, torch.Generator().manual_seed(SEED_TTS), device)
    voc = SW.init(cfg.vocoder, torch.Generator().manual_seed(SEED_VOC), device)
    g = torch.Generator().manual_seed(SEED_END)
    with torch.no_grad():
        for flow in voc.flows:
            for p in (flow.wn.end.w, flow.wn.end.b):
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    return tts, SW.fold_weightnorm(voc)


# -- phases -------------------------------------------------------------------


def phase_device():
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} x{torch.cuda.device_count()}")
    print(smi.stdout.strip().splitlines()[0])
    return kind


def phase_build():
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s -> "
          f"{_build.library_path()}")
    for line in _build.build_log_path().read_text().splitlines():
        if "registers" in line or re.search(r"[1-9]\d* bytes spill", line):
            print(f"[build] {line.strip()}")


def _flash_case(b, h, lq, lk, dtype, lens=None, causal=False, self_mask=True,
                sm_scale=1.0, q_offset=0):
    g = torch.Generator().manual_seed(SEED_DATA)
    q, k, v = (torch.randn(b, h, n, 64, generator=g).to("cuda", dtype)
               for n in (lq, lk, lk))
    mask = None
    if lens is not None:
        mask = (torch.arange(lk)[None, :] < torch.tensor(lens)[:, None]).cuda()
    kw = dict(causal=causal, self_mask=self_mask, sm_scale=sm_scale,
              q_offset=q_offset)
    return (q, k, v, mask), kw


def _dw_case(shape, taps, dtype, param_dtype=None):
    """x (shape) in ``dtype``; w (taps, 1, C) and b (C,) in ``param_dtype``
    (``dtype`` unless given: the vocoder passes its f32 parameters)."""
    g = torch.Generator().manual_seed(SEED_DATA)
    c = shape[-1]
    param_dtype = param_dtype or dtype
    return (torch.randn(*shape, generator=g).to("cuda", dtype),
            torch.randn(taps, 1, c, generator=g).to("cuda", param_dtype),
            torch.randn(c, generator=g).to("cuda", param_dtype))


def _plain_dw_grads(x, w, b, dy):
    """Gradients of x, w and b by autograd of the plain grouped conv in f32
    (w and b rounded to x's dtype, as K2 rounds them)."""
    k, c = w.shape[0], x.shape[-1]
    xf, wf, bf = (t.detach().to(x.dtype).float().requires_grad_()
                  for t in (x, w, b))
    y = F.conv1d(F.pad(xf.transpose(1, 2), ((k - 1) // 2, k // 2)),
                 wf.reshape(k, c).t().unsqueeze(1), bf, groups=c)
    y.transpose(1, 2).backward(dy.float())
    return xf.grad, wf.grad, bf.grad


def _check_dw_backward():
    """K2's Function on the card: one K2 launch forward, and gradients of
    x, w and b equal to the plain conv's autograd; then a backward through
    one full-width WN (f32, weight-norm form, "end" made live) gives every
    depth stage the gradient the plain version's autograd gives."""
    for dtype in (torch.bfloat16, torch.float32):
        x, w, b = _dw_case((8, 1024, 128), 3, dtype, torch.float32)
        dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(
            SEED_END)).to("cuda", dtype)
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        before = depthwise_conv1d.launches
        depthwise_conv1d(*leaves).backward(dy)
        torch.cuda.synchronize()
        _require(depthwise_conv1d.launches == before + 1,
                 "K2's Function did not launch K2 once")
        errs = [_scaled_err(t.grad, want) for t, want in zip(
            leaves, _plain_dw_grads(x, w, b, dy))]
        tol = KERNEL_TOL[dtype]
        print(f"[kernels] K2 Function backward (8,1024,128) K3 x "
              f"{str(dtype)[6:]}, w/b f32: dx {errs[0]:.3e}, dw {errs[1]:.3e}"
              f", db {errs[2]:.3e}; tol {tol:g}")
        _require(max(errs) <= tol, "K2's gradients disagree with the plain "
                 "conv's")

    cfg = base_config("float32").vocoder
    voc = SW.init(cfg, torch.Generator().manual_seed(SEED_VOC), "cuda")
    wn = voc.flows[0].wn
    with torch.no_grad():
        wn.end.w.copy_(0.02 * torch.randn(
            wn.end.w.shape, generator=torch.Generator().manual_seed(SEED_END)))
    g = torch.Generator().manual_seed(SEED_DATA)
    audio = torch.randn(2, 1024, cfg.n_group // 2, generator=g).cuda()
    mel = torch.randn(2, 1024, cfg.n_mels, generator=g).cuda()

    def depth_grads():
        voc.zero_grad()
        out = SW.wn_apply(wn, audio, mel, cfg.wn_layers, cfg.wn_channels)
        out.square().sum().backward()
        return [t.grad.clone() for d in wn.depth for t in (d.v, d.g, d.b)]

    before = depthwise_conv1d.launches
    got = depth_grads()
    n_k2 = depthwise_conv1d.launches - before
    SW.depthwise_conv1d = depthwise_conv1d_reference
    try:
        want = depth_grads()
    finally:
        SW.depthwise_conv1d = depthwise_conv1d
    err = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(got, want))
    print(f"[kernels] vocoder WN backward b2 x 1024 x 128 channels, 8 layers"
          f" (f32): K2 launches {n_k2}; depth v/g/b gradients vs the plain "
          f"conv's: max err {err:.3e} (relative to each tensor's largest), "
          f"tol {TRAIN_SLICE_TOL:g}")
    _require(n_k2 == cfg.wn_layers and err <= TRAIN_SLICE_TOL
             and all(bool(b.abs().max() > 0) for b in want),
             "the vocoder's depth gradients through K2 disagree")


ENCODER_LENS = (256, 200, 131, 77, 256, 1, 64, 250)


def phase_kernels():
    """Returns the max abs error of each kernel at its main-path shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf, f32 = torch.bfloat16, torch.float32
    flash_cases = {
        "encoder b8 h8 L256 bf16 self+pad": (8, 8, 256, 256, bf, ENCODER_LENS),
        "encoder b8 h8 L256 f32 self+pad": (8, 8, 256, 256, f32, ENCODER_LENS),
        "causal b2 h8 L256 bf16 self": (2, 8, 256, 256, bf, None, True),
        "cross b8 h8 Lq512 Lk256 bf16": (8, 8, 512, 256, bf, ENCODER_LENS,
                                         False, False, 0.125),
        "ragged b2 h8 L200 bf16 self+pad": (2, 8, 200, 200, bf, (200, 150)),
        # a sequence-parallel query shard: rows 128..227 of 256 keys
        "q_offset 128 b2 h8 Lq100 Lk256 bf16 causal+self+pad": (
            2, 8, 100, 256, bf, (256, 180), True, True, 1.0, 128),
    }
    main = {}
    for name, case in flash_cases.items():
        args, kw = _flash_case(*case)
        got, lse = flash_attend(*args, return_lse=True, **kw)
        torch.cuda.synchronize()
        want, want_lse = flash_attend_reference(*args, return_lse=True, **kw)
        err, abs_err = _scaled_err(got, want), _abs_err(got, want)
        lse_err = _scaled_err(lse, want_lse)
        tol = KERNEL_TOL[case[4]]
        print(f"[kernels] K1 {name}: max err {err:.3e} (abs {abs_err:.3e}), "
              f"lse err {lse_err:.3e}, tol {tol:g}")
        _require(err <= tol and lse_err <= 1e-5, f"K1 {name} disagrees")
        main.setdefault("flash", abs_err)
    for name, (shape, taps, dtype, param_dtype) in {
            "serving (1,1024,128) K3 bf16, w/b f32": ((1, 1024, 128), 3, bf,
                                                     f32),
            "vocoder (8,1024,128) K3 bf16, w/b f32": ((8, 1024, 128), 3, bf,
                                                     f32),
            "vocoder (8,1024,128) K3 bf16": ((8, 1024, 128), 3, bf, bf),
            "vocoder (8,1024,128) K3 f32": ((8, 1024, 128), 3, f32, f32),
            "(8,1024,128) K4 bf16": ((8, 1024, 128), 4, bf, bf),
            "(2,77,6) K3 f32 scalar path": ((2, 77, 6), 3, f32, f32),
            "(2,77,6) K4 bf16, w/b f32, scalar path": ((2, 77, 6), 4, bf,
                                                      f32)}.items():
        args = _dw_case(shape, taps, dtype, param_dtype)
        got = depthwise_conv1d(*args)
        torch.cuda.synchronize()
        want = depthwise_conv1d_reference(*args)
        err, abs_err = _scaled_err(got, want), _abs_err(got, want)
        tol = KERNEL_TOL[dtype]
        print(f"[kernels] K2 {name}: max err {err:.3e} (abs {abs_err:.3e}), "
              f"tol {tol:g}")
        _require(err <= tol, f"K2 {name} disagrees")
        main.setdefault("depthwise", abs_err)
    _check_dw_backward()
    return main


def phase_slice(cfg: Config):
    tts, voc = build_models(cfg, "cuda")
    syn = Synthesizer(cfg, tts, voc, max_frames=256)
    flash_attend.launches = 0
    depthwise_conv1d.launches = 0
    t0 = time.perf_counter()
    wavs = syn(SENTENCES)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"flash": flash_attend.launches,
                "depthwise": depthwise_conv1d.launches}
    # the lengths the decode produced, to check the waveforms against
    _, lengths = syn.text_to_mel(SENTENCES)
    hop = cfg.vocoder.hop_length
    print(f"[slice] {len(wavs)} sentences -> frames {lengths.tolist()} in "
          f"{dt:.2f} s; launches K1 {launches['flash']} K2 "
          f"{launches['depthwise']}")
    _require(len(wavs) == len(SENTENCES), "wrong number of waveforms")
    for w, n in zip(wavs, lengths):
        _require(w.shape == (int(n) * hop,), f"waveform {w.shape} for {n} "
                 "frames")
        _require(bool(np.isfinite(w).all()), "non-finite waveform")
    n_flash = cfg.model.encoder.num_layers
    n_dw = cfg.vocoder.n_flows * cfg.vocoder.wn_layers * len(SENTENCES)
    _require(launches["flash"] >= n_flash,
             f"K1 launched {launches['flash']} < {n_flash} times")
    _require(launches["depthwise"] >= n_dw,
             f"K2 launched {launches['depthwise']} < {n_dw} times")
    return syn, launches


@torch.no_grad()
def _run_f32(device, tokens, mask, z):
    cfg = base_config("float32", dec_prenet_dropout=0.0)
    tts, voc = build_models(cfg, device)
    tokens, mask, z = tokens.to(device), mask.to(device), z.to(device)
    memory = M.encode(tts, cfg.model, tokens, mask)
    res = decode_greedy(tts, cfg.model, memory, mask, max_frames=64,
                        stop_threshold=2.0)
    audio = SW._infer_chunk(voc, res.mel_post, z, cfg=cfg.vocoder)
    return res, audio


def phase_card_vs_cpu(cfg: Config):
    """The same weights and noise through the port at float32, on the card
    and on the CPU; prenet dropout is off and z comes from a CPU generator
    (CUDA and CPU generators give different streams from one seed)."""
    tokens, mask = encode_batch(SENTENCES[:2], pad_to_multiple=64)
    tokens = torch.as_tensor(np.asarray(tokens)).long()
    mask = torch.as_tensor(np.asarray(mask)).bool()
    l = 64 * cfg.vocoder.hop_length // cfg.vocoder.n_group
    z = torch.randn(2, l, cfg.vocoder.n_group,
                    generator=torch.Generator().manual_seed(SEED_DATA))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cpu_res, cpu_audio = _run_f32("cpu", tokens, mask, z)
    t1 = time.perf_counter()
    gpu_res, gpu_audio = _run_f32("cuda", tokens, mask, z)
    torch.cuda.synchronize()
    errs = {"mel": _scaled_err(gpu_res.mel_post, cpu_res.mel_post),
            "stop_logits": _scaled_err(gpu_res.stop_logits,
                                       cpu_res.stop_logits),
            "audio": _scaled_err(gpu_audio, cpu_audio)}
    same_len = bool((gpu_res.lengths.cpu() == cpu_res.lengths).all())
    print(f"[card-vs-cpu] f32, 2 utterances x 64 frames: "
          + ", ".join(f"{k} err {v:.3e}" for k, v in errs.items())
          + f", lengths equal {same_len}; tol {SLICE_TOL:g} "
          f"(cpu {t1 - t0:.1f} s)")
    _require(same_len and all(v <= SLICE_TOL for v in errs.values()),
             "card and CPU disagree")


def _events_ms(fn, n):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _interleaved_ms(fns, n=200, cycles=2):
    """Mean ms per call of each function of ``fns`` by the events loop,
    after a warm-up, in the order given and then reversed (A B C C B A),
    ``cycles`` times: a drift of the host's speed falls alike on all."""
    for fn in fns:
        _events_ms(fn, 10)
    order = list(range(len(fns)))
    times = [[] for _ in fns]
    for _ in range(cycles):
        for i in order + order[::-1]:
            times[i].append(_events_ms(fns[i], n))
    return [sum(t) / len(t) for t in times]


def _kernel_ms(kernel, plain, n=200):
    """(kernel, plain) mean ms per call, timed plain, kernel, kernel, plain."""
    plain_ms, kernel_ms = _interleaved_ms((plain, kernel), n, cycles=1)
    return kernel_ms, plain_ms


def _device_ms(fn, n, names=None):
    """Device time per call of ``fn`` from torch.profiler's kernel events
    over ``n`` calls (after a warm-up).  The profiler does not always record
    every launch (it has recorded 1 of 10 and 62 of 100), so each kernel
    counts as its mean time per recorded launch times its launches a call,
    ceil(recorded / n), and the call is the sum over its kernels.  With
    ``names``, only the kernels whose name holds one of them: each name must
    match, and each such kernel, launched once a call, must be recorded
    between 1 and n times; a profile that recorded none of a name's
    launches (it has happened once in 10 calls, and three times in a row
    for K7's path entry at 64 x 8192), or without ``names`` no kernel at
    all (once, for SDPA's forward at the longform cross), is taken again,
    six times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, 7):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        wanted = names or ("",)     # without names: any kernel at all
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.count > 0
                  and any(s in e.key for s in wanted)]
        counts = {e.key[:60]: e.count for e in device}
        if all(any(s in e.key for e in device) for s in wanted):
            break
        print(f"[profiler] profile {attempt} of 6 recorded {counts} "
              f"launches of {names or 'any kernel'} in {n} calls")
    if names is not None:
        _require(all(any(s in e.key for e in device) for s in names)
                 and all(1 <= c <= n for c in counts.values()),
                 f"the profiler recorded {counts} launches of {names} in "
                 f"{n} calls, not 1 to {n} of each")
        if any(c < n for c in counts.values()):
            print(f"[profiler] recorded fewer than {n} launches: {counts}")
    total = sum(e.self_device_time_total / e.count * -(-e.count // n)
                for e in device)
    _require(total > 0, f"the profiler saw no device time of {names}")
    return total / 1e3


def _print_resources(tag: str, names, entry: str, *args: int) -> None:
    """What the runtime reports of the bf16 kernels behind the entry point
    ``entry`` (``rtts_*_resources``) on this card, one line each."""
    for name, r in zip(names, _build.resources(entry, *args,
                                               kernels=len(names))):
        print(f"[{tag}] {name} on this card: {r['registers']} registers and "
              f"{r['spill_bytes']} spill bytes a thread, {r['smem_bytes']} B "
              f"of shared memory a block, {r['blocks_per_sm']} blocks an SM")


# the least time of a kernel's function on this card: the larger of its
# bytes (each input read once, each output written once) over the HBM rate
# and its operations over the peak rate of their type (H100 SXM at 700 W:
# dense bf16 tensor cores; f32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}


def _bound(n_bytes: float, n_ops: float, dtype) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _flash_bounds(b, h, lq, lk, dh, dtype, causal, masked):
    """Bounds of K1 (with lse) and of K3's two kernels at one shape.  The
    score pairs are the causal triangle's where the kernels skip the rest."""
    es = torch.tensor([], dtype=dtype).element_size()
    rows_q, rows_k = b * h * lq * dh * es, b * h * lk * dh * es
    lse, mask = b * h * lq * 4, b * lk if masked else 0
    pairs = b * h * (lq * (lq + 1) // 2 if causal else lq * lk)
    product = 2 * pairs * dh
    return {
        # q, k, v in; out (and lse) out; S = QK^T and P.V
        "fwd": _bound(2 * rows_q + 2 * rows_k + mask + lse, 2 * product,
                      dtype),
        # q, k, v, out, dO, lse in; dK, dV out; S, dP, dV, dK
        "dkv": _bound(3 * rows_q + 4 * rows_k + mask + lse, 4 * product,
                      dtype),
        # q, k, v, out, dO, lse in; dQ out; S, dP, dQ
        "dq": _bound(4 * rows_q + 2 * rows_k + mask + lse, 3 * product,
                     dtype),
    }


def _bench_inputs(cfg: Config, batch: int = 8, n_tok: int = 256):
    """Random token ids, all valid, as ``rtts/bench.py::bench_e2e`` draws."""
    g = torch.Generator().manual_seed(SEED_DATA)
    tokens = torch.randint(3, cfg.model.vocab_size, (batch, n_tok),
                           generator=g).cuda()
    return tokens, torch.ones(batch, n_tok, dtype=torch.bool, device="cuda")


def phase_timing(syn: Synthesizer):
    cfg = syn.cfg
    batch, n_tok, frames = 8, 256, 512
    tokens, mask = _bench_inputs(cfg, batch, n_tok)
    audio_s = batch * frames * cfg.dataset.audio.hop_length / \
        cfg.dataset.audio.sample_rate

    def run():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        ev[0].record()
        with torch.no_grad():   # serving's encode, as in Synthesizer
            memory = M.encode(syn.tts, cfg.model, tokens, mask)
        ev[1].record()
        res = decode_greedy(syn.tts, cfg.model, memory, mask,
                            max_frames=frames, generator=gen,
                            stop_threshold=2.0)
        ev[2].record()
        audio = SW.infer(syn.vocoder, cfg.vocoder, res.mel_post,
                         generator=gen)
        ev[3].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _require(audio.shape == (batch, frames * cfg.vocoder.hop_length)
                 and bool(torch.isfinite(audio).all()), "bench output")
        return wall, [ev[i].elapsed_time(ev[i + 1]) / 1e3 for i in range(3)]

    run()   # warm-up
    runs = [run() for _ in range(3)]
    wall, (enc, dec, voc) = min(runs)
    print(f"[timing] e2e b{batch} x {n_tok} tokens x {frames} frames "
          f"(bf16, kv_full, stop 2.0): walls "
          f"{[round(r[0], 4) for r in runs]} s; best {wall:.4f} s = "
          f"encode {enc:.4f} + decode {dec:.4f} + vocoder {voc:.4f} s")
    print(f"[timing] RTF {wall / audio_s:.5f} (audio {audio_s:.3f} s); "
          f"decode {batch * frames / dec:.0f} frames/s; vocoder RTF "
          f"{voc / audio_s:.5f}")

    bf = torch.bfloat16
    qkv, kw = _flash_case(8, 8, 256, 256, bf, ENCODER_LENS)
    flash_fn = lambda: flash_attend(*qkv, **kw)  # noqa: E731
    flash_ms = _kernel_ms(flash_fn, lambda: flash_attend_reference(*qkv, **kw))
    flash_dev = _device_ms(flash_fn, 100, ("flash_fwd",))
    flash_bound = _flash_bounds(8, 8, 256, 256, 64, bf, False, True)["fwd"]
    print(f"[timing] K1 encoder shape b8 h8 L256 dh64 bf16: kernel "
          f"{flash_ms[0]:.4f} ms (device {flash_dev:.4f}), plain "
          f"{flash_ms[1]:.4f} ms, bound {flash_bound['bound_ms']:.4f} ms "
          f"({flash_bound['bound_by']})")
    dw = {shape: _dw_times(shape) for shape in ((8, 1024, 128),
                                                (1, 1024, 128))}
    return {"flash": dict(ms=flash_ms[0], plain_ms=flash_ms[1],
                          device_ms=flash_dev, library_ms=None, **flash_bound),
            # the serving path's shape: Synthesizer vocodes one utterance
            # at a time, which is where phase 4 counts K2's launches
            "depthwise": dw[(1, 1024, 128)]}


def _dw_times(shape, n=200) -> dict:
    """K2 at (B, L, 128) bf16, 3 taps, with f32 weight and bias as the
    vocoder passes them: the kernel, its plain version and the library call
    (one grouped cuDNN convolution on the same values in its channels-first
    layout, weights cast ahead; the layout change is not timed), each by
    the events loop in turns (ms: the host's launch rate of back-to-back
    calls when that is slower than the device) and by the profiler
    (device_ms), and the bound."""
    bf, c = torch.bfloat16, shape[-1]
    x, w, b = _dw_case(shape, 3, bf, torch.float32)
    kernel = lambda: depthwise_conv1d(x, w, b)  # noqa: E731
    plain = lambda: depthwise_conv1d_reference(x, w, b)  # noqa: E731
    x_t = x.transpose(1, 2).contiguous()
    w_t = w.to(bf).reshape(3, c).t().unsqueeze(1).contiguous()
    b_t = b.to(bf)
    conv = lambda: F.conv1d(x_t, w_t, b_t, padding=1, groups=c)  # noqa: E731
    _require(_scaled_err(conv().transpose(1, 2), plain()) <= KERNEL_TOL[bf],
             "F.conv1d computes another function than K2")
    # a training call goes through K2's autograd.Function (x requires grad)
    x_grad = x.detach().requires_grad_()
    function = lambda: depthwise_conv1d(x_grad, w, b)  # noqa: E731
    k_ms, conv_ms, plain_ms, fn_ms = _interleaved_ms(
        (kernel, conv, plain, function), n)
    dev = {"kernel": _device_ms(kernel, n, ("depthwise_conv_kernel",)),
           "plain": _device_ms(plain, n), "conv": _device_ms(conv, n)}
    elems = x.numel()
    bound = _bound(2 * elems * 2 + 4 * c * 4, 2 * 3 * elems, torch.float32)
    print(f"[timing] K2 {shape} K3 bf16, w/b f32: kernel {k_ms:.4f} ms "
          f"(device {dev['kernel']:.4f}), plain {plain_ms:.4f} ms (device "
          f"{dev['plain']:.4f}), F.conv1d(groups={c}) {conv_ms:.4f} ms "
          f"(device {dev['conv']:.4f}), bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}); through the autograd.Function (x "
          f"requiring grad) {fn_ms:.4f} ms")
    return dict(ms=k_ms, plain_ms=plain_ms, device_ms=dev["kernel"],
                library_ms=conv_ms, **bound)


def phase_profile(syn: Synthesizer, frames: int = 64, top: int = 6):
    """One decode of ``frames`` frames at the timing shape under
    torch.profiler (after an unprofiled warm-up)."""
    cfg = syn.cfg
    tokens, mask = _bench_inputs(cfg)
    with torch.no_grad():
        memory = M.encode(syn.tts, cfg.model, tokens, mask)

    def decode():
        gen = torch.Generator(device="cuda").manual_seed(0)
        decode_greedy(syn.tts, cfg.model, memory, mask, max_frames=frames,
                      generator=gen, stop_threshold=2.0)
        torch.cuda.synchronize()

    decode()
    wall, busy, n_kernels, ops = _profile(decode, top)
    steps = frames // cfg.model.reduction_factor
    print(f"[profile] decode b{tokens.shape[0]} x {frames} frames (bf16, "
          f"kv_full): wall {wall:.4f} s, device busy {busy:.4f} s, idle "
          f"{1 - busy / wall:.1%}; {n_kernels} device activities, "
          f"{n_kernels / steps:.1f} per step")
    print(f"[profile] device time by op: {ops}")


def _profile_events(fn):
    """Run ``fn`` (which ends in a synchronize) once under torch.profiler
    -> (wall s, the profiler's ``key_averages()``).  The wall includes the
    profiler's own host overhead."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    return wall, prof.key_averages()


def _profile_summary(events, top: int = 6):
    """-> (device busy s, device activities, the top ops by device time as
    text).  Device busy is the sum of the device activities recorded."""
    from torch.autograd import DeviceType

    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e6
    n_kernels = sum(e.count for e in device)
    _require(busy > 0 and n_kernels > 0, "the profiler saw no device work")
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)[:top]
    return busy, n_kernels, ", ".join(
        f"{e.key} {e.self_device_time_total / 1e6 / busy:.1%}" for e in ops)


def _profile(fn, top: int = 6):
    """Run ``fn`` (which ends in a synchronize) once under torch.profiler
    -> (wall s, device busy s, device activities, the top ops by device
    time as text)."""
    wall, events = _profile_events(fn)
    return (wall, *_profile_summary(events, top))


# -- training phases ------------------------------------------------------------

# ragged lengths of the train batch: the longest fill the padded shapes
TRAIN_TOKEN_LENS = (256, 200, 131, 77, 256, 9, 64, 250)
TRAIN_FRAME_LENS = (1024, 800, 524, 308, 1000, 40, 256, 1024)

TRAIN_FLASH_CASES = {
    # name: (b, h, lq, lk, kv lengths, causal, self_mask, sm_scale, q_offset)
    "encoder b8 h8 L256 self+pad": (8, 8, 256, 256, ENCODER_LENS, False,
                                    True, 1.0, 0),
    "decoder b8 h8 L1024 causal+self": (8, 8, 1024, 1024, None, True, True,
                                        1.0, 0),
    "cross b8 h8 Lq1024 Lk256 pad": (8, 8, 1024, 256, ENCODER_LENS, False,
                                     False, 0.125, 0),
    "q_offset 128 b2 h4 Lq100 Lk256 causal+self+pad": (
        2, 4, 100, 256, (256, 180), True, True, 1.0, 128),
    # the longform_8k.yaml decoder's cross-attention (phases 12 and 14)
    "cross b2 h8 Lq8192 Lk1024 pad": (2, 8, 8192, 1024, (1024, 700), False,
                                      False, 0.125, 0),
}
# the shapes at which the kernels line reports K1 and K3 (times, bounds
# and errors): base.yaml's decoder self-attention, and K1 again at the
# longform decoder's cross-attention
BASE_DECODER = "decoder b8 h8 L1024 causal+self"
LONGFORM_CROSS = "cross b2 h8 Lq8192 Lk1024 pad"


def train_config(compute_dtype: str = "bfloat16", num_layers=None,
                 dropout_off: bool = False, attention_dropout: float = 0.0,
                 base=BASE_CONFIG, stack_overrides=None, **optim) -> Config:
    """``base`` (base.yaml by default) for training: ``num_layers`` cuts
    both stacks, ``dropout_off`` sets every dropout rate to 0 (the decoder
    prenet's included), so two devices can take the same step, and
    ``stack_overrides`` (a dict) sets keys of both stacks."""
    data = copy.deepcopy(base)
    model = data["model"]
    model.update(vocab_size=frontend_vocab_size("char"),
                 compute_dtype=compute_dtype)
    for stack in (model["encoder"], model["decoder"]):
        stack.update(stack_overrides or {})
        stack["attention"]["attention_dropout"] = attention_dropout
        if num_layers is not None:
            stack["num_layers"] = num_layers
        if dropout_off:
            stack["dropout"] = 0.0
    if dropout_off:
        model.update(enc_prenet_dropout=0.0, dec_prenet_dropout=0.0,
                     postnet_dropout=0.0)
    data.setdefault("experiment", {}).setdefault("optim", {}).update(optim)
    return from_dict(Config, data)


def train_batch(cfg: Config, token_lens, frame_lens, device):
    """Seeded random batch: token ids and mels, zero past each length."""
    g = torch.Generator().manual_seed(SEED_DATA)
    b, l, t = len(token_lens), max(token_lens), max(frame_lens)
    token_mask = torch.arange(l)[None, :] < torch.tensor(token_lens)[:, None]
    mel_mask = torch.arange(t)[None, :] < torch.tensor(frame_lens)[:, None]
    tokens = torch.randint(3, cfg.model.vocab_size, (b, l), generator=g)
    mel = 0.5 * torch.randn(b, t, cfg.model.n_mels, generator=g)
    batch = {"tokens": tokens * token_mask, "token_mask": token_mask,
             "mel": mel * mel_mask[..., None], "mel_mask": mel_mask}
    return {k: v.to(device) for k, v in batch.items()}


def _trainer(cfg: Config, device):
    """Seeded model, optimizer state and train step."""
    model = M.init(cfg.model, torch.Generator().manual_seed(SEED_TTS), device)
    optimizer = make_optimizer(cfg.experiment.optim)
    state = optimizer.init(list(model.parameters()))
    return model, state, make_train_step(cfg.model, optimizer)


_TRAIN_KERNELS = (flash_attend, flash_bwd_dkv, flash_bwd_dq)


def _reset_train_counts():
    for fn in _TRAIN_KERNELS:
        fn.launches = 0


def _train_counts():
    return {"flash_train": flash_attend.launches,
            "flash_bwd_dkv": flash_bwd_dkv.launches,
            "flash_bwd_dq": flash_bwd_dq.launches}


def _train_flash_case(b, h, lq, lk, lens, causal, self_mask, sm_scale,
                      q_offset, dtype):
    """(q, k, v, dout), kv_mask and (causal, self_mask, sm_scale,
    q_offset); self-attention cases get the shared-QK keys."""
    g = torch.Generator().manual_seed(SEED_DATA)
    q, k, v, dout = (torch.randn(b, h, n, 64, generator=g)
                     for n in (lq, lk, lk, lq))
    if self_mask and lq == lk:   # keys = length-normalized queries / sqrt(d)
        k = q * torch.rsqrt((q * q).mean(-1, keepdim=True) + 1e-6) * 64 ** -0.5
    mask = None
    if lens is not None:
        mask = (torch.arange(lk)[None, :] < torch.tensor(lens)[:, None]).cuda()
    tensors = [t.to("cuda", dtype) for t in (q, k, v, dout)]
    return tensors, mask, (causal, self_mask, sm_scale, q_offset)


def _check_keep_masks():
    """With q = k = 0 every probability is 1/L, so K1 with v = I returns
    keep / (L keep_prob) and K3's dV with dO = I its transpose: both give
    the kernels' keep bits, held against the dense mask."""
    b, h, l, rate = 2, 3, 128, 0.1
    zeros = torch.zeros(b, h, l, l, device="cuda")
    eye = torch.eye(l, device="cuda").expand(b, h, l, l).contiguous()
    for q_offset in (0, 37):
        args = (False, False, 1.0, q_offset, rate, DROP_SEED)
        out, lse = flash_fwd(zeros, zeros, eye, None, *args)
        _, dv = flash_bwd_dkv(zeros, zeros, eye, out, eye, lse, None, *args)
        want = dropout_keep_mask(DROP_SEED, b * h, l, l, rate, q_offset,
                                 "cuda").reshape(b, h, l, l)
        same = (torch.equal((out > 0).float(), want)
                and torch.equal((dv.transpose(-1, -2) > 0).float(), want))
        print(f"[kernels-train] keep mask b{b} h{h} L{l} rate {rate} "
              f"q_offset {q_offset}: K1 and K3 equal dropout_keep_mask "
              f"bit for bit: {same} (kept {want.mean().item():.4f})")
        _require(same, "a kernel's keep mask differs from dropout_keep_mask")


def phase_kernels_train():
    """K1 (with dropout, returning lse) and K3 against the plain forward
    and backward run in f32 on the same inputs.  Returns the max abs error
    of each kernel in bf16 at dropout 0 at the shapes the kernels line
    reports: BASE_DECODER for K1 and K3, LONGFORM_CROSS for K1 as
    "flash_cross"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    main = {}
    for name, case in TRAIN_FLASH_CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            for rate in (0.0, 0.1):
                (q, k, v, dout), mask, opts = _train_flash_case(*case, dtype)
                args = (*opts, rate, DROP_SEED)
                out, lse = flash_fwd(q, k, v, mask, *args)
                dk, dv = flash_bwd_dkv(q, k, v, out, dout, lse, mask, *args)
                dq = flash_bwd_dq(q, k, v, out, dout, lse, mask, *args)
                torch.cuda.synchronize()
                f = [t.float() for t in (q, k, v)]
                kw = dict(zip(("causal", "self_mask", "sm_scale", "q_offset"),
                              opts), dropout_rate=rate, dropout_seed=DROP_SEED)
                want, want_lse = flash_attend_reference(
                    *f, mask, return_lse=True, **kw)
                wants = flash_attend_bwd_reference(
                    *f, out.float(), dout.float(), lse, mask, **kw)
                got = {"out": out, "dq": dq, "dk": dk, "dv": dv}
                ref = {"out": want, "dq": wants[0], "dk": wants[1],
                       "dv": wants[2]}
                errs = {key: _scaled_err(got[key], ref[key]) for key in got}
                lse_err = _scaled_err(lse, want_lse)
                tol = KERNEL_TOL[dtype]
                print(f"[kernels-train] {name} {str(dtype)[6:]} dropout "
                      f"{rate}: " + ", ".join(f"{key} {e:.3e}"
                                              for key, e in errs.items())
                      + f", lse {lse_err:.3e}; tol {tol:g}")
                _require(all(e <= tol for e in errs.values())
                         and lse_err <= 1e-5, f"K1/K3 {name} disagree")
                for kernel, keys in (("flash_train", ("out",)),
                                     ("flash_bwd_dkv", ("dk", "dv")),
                                     ("flash_bwd_dq", ("dq",))):
                    if name == BASE_DECODER:
                        main.setdefault(kernel, max(
                            _abs_err(got[key], ref[key]) for key in keys))
                if name == LONGFORM_CROSS:
                    main.setdefault("flash_cross",
                                    _abs_err(got["out"], ref["out"]))
    _check_keep_masks()
    return main


def _check_step(cfg: Config, metrics, grads, names, what):
    """Finite loss and grad norm; a finite gradient on every parameter,
    nonzero except on the last postnet layer's LN, which the forward never
    reads (the reference's gradient there is zero too)."""
    _require(all(bool(torch.isfinite(v)) for v in metrics.values()),
             f"{what}: non-finite metrics {metrics}")
    unread = f"postnet.{cfg.model.postnet_layers - 1}.ln."
    for name, g in zip(names, grads):
        _require(bool(torch.isfinite(g).all()),
                 f"{what}: non-finite gradient of {name}")
        _require(name.startswith(unread) or bool((g != 0).any()),
                 f"{what}: zero gradient of {name}")


def phase_train():
    """Three base.yaml train steps, then one with attention dropout 0.1.
    Returns the model (for the timing phase) and the launch counts of the
    three steps."""
    cfg = train_config()
    model, state, step_fn = _trainer(cfg, "cuda")
    names = [n for n, _ in model.named_parameters()]
    batch = train_batch(cfg, TRAIN_TOKEN_LENS, TRAIN_FRAME_LENS, "cuda")
    per_step = cfg.model.encoder.num_layers + cfg.model.decoder.num_layers
    _reset_train_counts()
    t0 = time.perf_counter()
    steps = [step_fn(model, state, batch,
                     step_generator(SEED_TRAIN, step, "cuda"), step,
                     return_grads=True) for step in range(3)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _train_counts()
    for step, (metrics, grads) in enumerate(steps):
        _check_step(cfg, metrics, grads, names, f"train step {step}")
        print(f"[train] step {step}: loss {float(metrics['loss']):.6f} "
              f"(guided {float(metrics['loss_guided_attn']):.6f}), grad_norm "
              f"{float(metrics['grad_norm']):.6f}")
    print(f"[train] base.yaml b{len(TRAIN_TOKEN_LENS)} tokens "
          f"{list(TRAIN_TOKEN_LENS)} frames {list(TRAIN_FRAME_LENS)} bf16: 3 "
          f"steps in {dt:.2f} s (the first one cold); launches {launches}")
    _require(all(n == 3 * per_step for n in launches.values()),
             f"expected {per_step} launches of each kernel per step, got "
             f"{launches} over 3 steps")

    drop_cfg = train_config(attention_dropout=0.1)
    optimizer = make_optimizer(drop_cfg.experiment.optim)
    drop_step = make_train_step(drop_cfg.model, optimizer)
    _reset_train_counts()
    metrics, grads = drop_step(model, state, batch,
                               step_generator(SEED_TRAIN, 3, "cuda"), 3,
                               return_grads=True)
    torch.cuda.synchronize()
    drop_launches = _train_counts()
    _check_step(drop_cfg, metrics, grads, names, "dropout step")
    print(f"[train] step 3 with attention_dropout 0.1: loss "
          f"{float(metrics['loss']):.6f}, grad_norm "
          f"{float(metrics['grad_norm']):.6f}; launches {drop_launches}")
    _require(all(n == per_step for n in drop_launches.values()),
             f"dropout step: launches {drop_launches}")
    return model, launches


def _f32_step(cfg: Config, batch, device):
    """-> (metrics as floats, gradients, parameters after the update), on
    the CPU."""
    model, state, step_fn = _trainer(cfg, device)
    batch = {k: v.to(device) for k, v in batch.items()}
    metrics, grads = step_fn(model, state, batch,
                             step_generator(SEED_TRAIN, 0, device), 0,
                             return_grads=True)
    return ({k: float(v) for k, v in metrics.items()},
            [g.cpu() for g in grads],
            [p.detach().cpu() for p in model.parameters()])


def phase_train_card_vs_cpu():
    """One f32 step at 2 + 2 layers, every dropout 0, constant lr: the
    card (K1/K3) against the CPU (the plain versions in the same
    autograd.Function), from the same weights and batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_config("float32", num_layers=2, dropout_off=True,
                       schedule="constant")
    lr = cfg.experiment.optim.learning_rate
    lens = ((256, 131, 77, 200), (512, 300, 160, 400))
    batch = train_batch(cfg, *lens, "cpu")
    t0 = time.perf_counter()
    cpu = _f32_step(cfg, batch, "cpu")
    t1 = time.perf_counter()
    _reset_train_counts()
    card = _f32_step(cfg, batch, "cuda")
    launches = _train_counts()
    init = M.init(cfg.model, torch.Generator().manual_seed(SEED_TTS), "cpu")
    names = [n for n, _ in init.named_parameters()]
    loss_err = abs(card[0]["loss"] - cpu[0]["loss"]) / max(
        1.0, abs(cpu[0]["loss"]))
    norm_err = abs(card[0]["grad_norm"] - cpu[0]["grad_norm"]) / max(
        1.0, abs(cpu[0]["grad_norm"]))
    grad_errs = {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)
                     ).item() for n, a, b in zip(names, card[1], cpu[1])}
    worst = max(grad_errs, key=grad_errs.get)
    param_err = max((a - b).abs().max().item()
                    for a, b in zip(card[2], cpu[2]))
    moved = max((a - b.detach()).abs().max().item()
                for a, b in zip(cpu[2], init.parameters()))
    print(f"[train-card-vs-cpu] f32 2+2 layers b4 tokens {list(lens[0])} "
          f"frames {list(lens[1])}: loss {card[0]['loss']:.6f} vs "
          f"{cpu[0]['loss']:.6f} (err {loss_err:.3e}), grad_norm err "
          f"{norm_err:.3e}, worst gradient leaf {worst} {grad_errs[worst]:.3e}"
          f" (relative to its largest entry), params after the update "
          f"{param_err:.3e} (lr {lr:g}, largest move {moved:.3e}); tol "
          f"{TRAIN_SLICE_TOL:g}, params {TRAIN_PARAM_TOL_LR:g} lr; card "
          f"launches {launches} (cpu {t1 - t0:.1f} s)")
    _require(all(n > 0 for n in launches.values()),
             "the card's step ran no kernel")
    _require(loss_err <= TRAIN_SLICE_TOL and norm_err <= TRAIN_SLICE_TOL
             and grad_errs[worst] <= TRAIN_SLICE_TOL
             and param_err <= TRAIN_PARAM_TOL_LR * lr,
             "card and CPU train steps disagree")


def phase_train_timing(model):
    """The bf16 train step at b8 x 256 tokens x 1024 frames, every
    position valid: best of 3 after a warm-up; one step under
    torch.profiler; K1 and K3 against their plain versions."""
    cfg = train_config()
    optimizer = make_optimizer(cfg.experiment.optim)
    state = optimizer.init(list(model.parameters()))
    step_fn = make_train_step(cfg.model, optimizer)
    b, n_tok, frames = 8, 256, 1024
    batch = train_batch(cfg, (n_tok,) * b, (frames,) * b, "cuda")
    gen = torch.Generator(device="cuda")

    def step():
        metrics = step_fn(model, state, batch, gen.manual_seed(SEED_TRAIN),
                          state["count"])
        torch.cuda.synchronize()
        return metrics

    step()   # warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        metrics = step()
        walls.append(time.perf_counter() - t0)
        _require(bool(torch.isfinite(metrics["loss"])), "timed step loss")
    best = min(walls)
    print(f"[train-timing] train step b{b} x {n_tok} tokens x {frames} frames "
          f"(base.yaml, bf16): walls {[round(w, 4) for w in walls]} s; best "
          f"{best:.4f} s = {b * frames / best:.0f} frames/s")
    wall, busy, n_kernels, ops = _profile(step)
    print(f"[train-timing] profile of one step: wall {wall:.4f} s, device "
          f"busy {busy:.4f} s, idle {1 - busy / wall:.1%}; {n_kernels} device "
          f"activities; device time by op: {ops}")

    return {name: _flash_times(case, n, "train-timing")
            for name, case, n in (
                ("decoder", BASE_DECODER, 20),
                ("encoder", "encoder b8 h8 L256 self+pad", 100))}


def _flash_times(case: str, n: int, tag: str, sdpa: bool = False) -> dict:
    """K1 (with lse) and K3's two kernels at a TRAIN_FLASH_CASES shape in
    bf16, against their plain versions (n calls each, in turns), with their
    device time from the profiler and their bounds -> {kernel: times and
    bound}.  ``sdpa`` also times F.scaled_dot_product_attention's forward
    + backward on the same inputs as a yardstick (pad masks only)."""
    (q, k, v, dout), mask, opts = _train_flash_case(*TRAIN_FLASH_CASES[case],
                                                    torch.bfloat16)
    args = (*opts, 0.0, 0)
    kw = dict(zip(("causal", "self_mask", "sm_scale", "q_offset"), opts))
    out, lse = flash_fwd(q, k, v, mask, *args)
    fns = {"flash_train": lambda: flash_fwd(q, k, v, mask, *args),
           "flash_bwd_dkv": lambda: flash_bwd_dkv(q, k, v, out, dout, lse,
                                                  mask, *args),
           "flash_bwd_dq": lambda: flash_bwd_dq(q, k, v, out, dout, lse, mask,
                                                *args)}
    plain_bwd = lambda: flash_attend_bwd_reference(  # noqa: E731
        q, k, v, out, dout, lse, mask, **kw)
    plains = {"flash_train": lambda: flash_attend_reference(
        q, k, v, mask, return_lse=True, **kw),
        "flash_bwd_dkv": plain_bwd, "flash_bwd_dq": plain_bwd}
    names = {"flash_train": ("flash_fwd",),
             "flash_bwd_dkv": ("flash_bwd_di", "flash_bwd_dkv"),
             "flash_bwd_dq": ("flash_bwd_dq",)}
    times = {kernel: _kernel_ms(fn, plains[kernel], n)
             for kernel, fn in fns.items()}
    dev = {kernel: _device_ms(fn, n, names[kernel])
           for kernel, fn in fns.items()}
    b, h, l, lk = TRAIN_FLASH_CASES[case][:4]
    bounds = _flash_bounds(b, h, l, lk, 64, torch.bfloat16, opts[0],
                           mask is not None)
    fwd, dkv, dq = (times[kernel] for kernel in fns)
    print(f"[{tag}] {case} bf16: K1 fwd+lse {fwd[0]:.4f} ms (device "
          f"{dev['flash_train']:.4f}; plain {fwd[1]:.4f}, bound "
          f"{bounds['fwd']['bound_ms']:.4f} {bounds['fwd']['bound_by']}); "
          f"K3 dK/dV {dkv[0]:.4f} ms (device {dev['flash_bwd_dkv']:.4f}; "
          f"bound {bounds['dkv']['bound_ms']:.4f} {bounds['dkv']['bound_by']})"
          f" + dQ {dq[0]:.4f} ms (device {dev['flash_bwd_dq']:.4f}; bound "
          f"{bounds['dq']['bound_ms']:.4f} {bounds['dq']['bound_by']}) = "
          f"{dkv[0] + dq[0]:.4f} ms (plain backward, all three gradients: "
          f"{dkv[1]:.4f} ms)")
    library = {}
    if sdpa:
        lib = _sdpa_fwd_bwd(q, k, v, dout, mask, opts[2], n)
        fwd_lib = _sdpa_fwd(q, k, v, mask, opts[2], n)
        library["flash_train"] = fwd_lib["ms"]
        ours = fwd[0] + dkv[0] + dq[0]
        ours_dev = sum(dev.values())
        print(f"[{tag}] {case} bf16 forward: K1 {fwd[0]:.4f} ms (device "
              f"{dev['flash_train']:.4f}); F.scaled_dot_product_attention "
              f"forward alone (bool pad mask, dropout 0; out err "
              f"{fwd_lib['err']:.3e}) {fwd_lib['ms']:.4f} ms (device "
              f"{fwd_lib['device_ms']:.4f}); card now: {_clocks()}")
        print(f"[{tag}] {case} bf16 forward + backward: K1 + K3 {ours:.4f} ms "
              f"(device {ours_dev:.4f}); the plain versions "
              f"{fwd[1] + dkv[1]:.4f} ms; F.scaled_dot_product_attention "
              f"(bool pad mask, dropout 0; out err {lib['err']:.3e}) "
              f"{lib['ms']:.4f} ms (device {lib['device_ms']:.4f})")
    return {kernel: dict(ms=times[kernel][0], plain_ms=times[kernel][1],
                         device_ms=dev[kernel],
                         library_ms=library.get(kernel), **bounds[part])
            for kernel, part in (("flash_train", "fwd"),
                                 ("flash_bwd_dkv", "dkv"),
                                 ("flash_bwd_dq", "dq"))}


def _sdpa_fwd_bwd(q, k, v, dout, mask, sm_scale, n) -> dict:
    """F.scaled_dot_product_attention forward + backward (q, k and v
    gradients) with a boolean pad mask and no dropout: for pad-only masks
    and rows with a valid key, the function of K1 + K3.  A yardstick the
    port never calls."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    attn_mask = mask[:, None, None, :]

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask,
                                             scale=sm_scale)
        return out, torch.autograd.grad(out, leaves, dout)

    out = fwd_bwd()[0]
    err = _scaled_err(out, flash_attend_reference(
        q.float(), k.float(), v.float(), mask, sm_scale=sm_scale))
    _require(err <= KERNEL_TOL[torch.bfloat16],
             "F.scaled_dot_product_attention computes another function")
    return {"ms": _interleaved_ms((fwd_bwd,), n)[0],
            "device_ms": _device_ms(fwd_bwd, n), "err": err}


def _clocks() -> str:
    """The card's SM and memory clocks, power draw and temperature, as
    nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip()


def _sdpa_fwd(q, k, v, mask, sm_scale, n) -> dict:
    """F.scaled_dot_product_attention's forward alone, with a boolean pad
    mask and no dropout, under no_grad: K1's function at pad-only masks
    (rows with a valid key).  A yardstick the port never calls."""
    attn_mask = mask[:, None, None, :]

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                                  scale=sm_scale)

    err = _scaled_err(fwd(), flash_attend_reference(
        q.float(), k.float(), v.float(), mask, sm_scale=sm_scale))
    _require(err <= KERNEL_TOL[torch.bfloat16],
             "F.scaled_dot_product_attention computes another function")
    return {"ms": _interleaved_ms((fwd,), n)[0],
            "device_ms": _device_ms(fwd, n), "err": err}


# -- LSH training phases (configs/longform_8k.yaml) -----------------------------

# configs/longform_8k.yaml as a dict (tests/test_torch_guards.py holds the
# two equal)
_LONGFORM_ATTENTION = {"kind": "lsh", "num_heads": 8, "head_dim": 64,
                       "num_hashes": 4, "chunk_length": 64,
                       "num_chunks_before": 1}
_LONGFORM_STACK = {"num_layers": 6, "d_model": 512, "d_ff": 2048,
                   "ffn_chunk_size": "auto", "reversible": "auto",
                   "auto_plain_budget_mb": 12288}
LONGFORM_CONFIG = {
    "dataset": {"batch_size": 2, "max_mel_len": 8192,
                "mel_pad_to_multiple": 64},
    "model": {
        "d_model": 512,
        "n_mels": 80,
        "max_pos": 8192,
        "encoder": dict(_LONGFORM_STACK, causal=False,
                        attention=dict(_LONGFORM_ATTENTION)),
        "decoder": dict(_LONGFORM_STACK, causal=True,
                        attention=dict(_LONGFORM_ATTENTION)),
        "compute_dtype": "bfloat16",
    },
}

# the ragged LSH train batch: the longest rows fill the padded shapes
LSH_TOKEN_LENS = (1024, 700)
LSH_FRAME_LENS = (8192, 6000)

LSH_CASES = {
    # name: (b, h, n_hashes, L, c, causal, before, after, valid lengths)
    "decoder b2 h8 nh4 L8192 c64 causal": (2, 8, 4, 8192, 64, True, 1, 0,
                                           None),
    "encoder b2 h8 nh4 L1024 c64": (2, 8, 4, 1024, 64, False, 1, 0, None),
    "ragged b2 h8 nh4 L1024 c64 causal, invalid keys": (
        2, 8, 4, 1024, 64, True, 1, 0, (1024, 700)),
    "nc 60 (not a multiple of 8) b2 h8 nh4 L960 c64 causal, invalid keys": (
        2, 8, 4, 960, 64, True, 1, 0, (960, 500)),
    # K5's dK/dV kernel meets query chunks from both sides
    "window 3 (before 1, after 1) b2 h8 nh4 L1024 c64 causal, invalid keys": (
        2, 8, 4, 1024, 64, True, 1, 1, (1024, 700)),
    # serving_fast.yaml's train step (phases 16 and 18) at its ragged lengths
    "serving_fast decoder b8 h8 nh4 L1024 c64 causal": (
        8, 8, 4, 1024, 64, True, 1, 0, TRAIN_FRAME_LENS),
    "serving_fast encoder b8 h8 nh4 L256 c64 (nc 16)": (
        8, 8, 4, 256, 64, False, 1, 0, TRAIN_TOKEN_LENS),
}
_LSH_DECODER, _LSH_ENCODER = list(LSH_CASES)[:2]

# share of the f32 hash buckets that must agree card vs CPU: the hash is an
# argmax over rotated vectors, so a last-bit difference of the rotation
# GEMM (cuBLAS vs the CPU BLAS) flips a near-tie
BUCKET_SHARE_MIN = 0.999


def _lsh_case(b, h, nh, l, c, causal, before, after, lens, dtype):
    """Chunk-attend inputs as the LSH pipeline makes them: per (batch, head,
    round) a permutation of the positions, keys the length-normalised
    queries, validity from the lengths; cotangents of out and lse."""
    g = torch.Generator().manual_seed(SEED_DATA)
    nc = nh * l // c
    q, v, dout = (torch.randn(b, h, nc, c, 64, generator=g) for _ in range(3))
    k = q * torch.rsqrt((q * q).mean(-1, keepdim=True) + 1e-6) * 64 ** -0.5
    pos = torch.stack([torch.randperm(l, generator=g)
                       for _ in range(b * h * nh)]).reshape(b, h, nc, c)
    lens = torch.tensor(lens if lens is not None else (l,) * b)
    valid = pos < lens[:, None, None, None]
    dlse = torch.randn(b, h, nc, c, generator=g)
    return ([t.to("cuda", dtype) for t in (q, k, v, dout)], pos.cuda(),
            valid.cuda(), dlse.cuda(), (causal, before, after))


def _lsh_bounds(b, h, nh, l, c, causal, before, after, lens, dtype):
    """Bounds of K4 and K5 at one shape: the window's scores are computed
    whole, masked or not, so every (query, window key) pair counts."""
    es = torch.tensor([], dtype=dtype).element_size()
    rows = b * h * nh * l
    size = rows * 64 * es
    per_row = 4 + 1 + 4          # position, validity, lse (or dlse)
    product = 2 * rows * (before + 1 + after) * c * 64
    return {"fwd": _bound(4 * size + rows * per_row, 2 * product, dtype),
            "bwd": _bound(7 * size + rows * per_row, 5 * product, dtype)}


def phase_kernels_lsh():
    """K4 and K5 against their plain versions run in f32 on the same inputs,
    in bf16 and f32, at the longform and serving_fast shapes; K5 twice,
    bit-equal.  Returns
    the max abs error of each at the decoder shape in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    main = {}
    for name, case in LSH_CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            (q, k, v, dout), pos, valid, dlse, opts = _lsh_case(*case, dtype)
            out, lse = lsh_attend_fwd(q, k, v, pos, valid, *opts)
            out2, lse2 = lsh_attend_fwd(q, k, v, pos, valid, *opts)
            grads = lsh_attend_bwd(q, k, v, pos, valid, dout, dlse, *opts)
            again = lsh_attend_bwd(q, k, v, pos, valid, dout, dlse, *opts)
            torch.cuda.synchronize()
            same_fwd = torch.equal(out, out2) and torch.equal(lse, lse2)
            f = [t.float() for t in (q, k, v)]
            want, want_lse = lsh_attend_chunks_reference(*f, pos, valid, *opts)
            wants = lsh_attend_bwd_reference(*f, pos, valid, dout.float(),
                                             dlse, *opts)
            got = dict(zip(("out", "dq", "dk", "dv"), (out, *grads)))
            ref = dict(zip(("out", "dq", "dk", "dv"), (want, *wants)))
            errs = {key: _scaled_err(got[key], ref[key]) for key in got}
            lse_err = _scaled_err(lse, want_lse)
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            tol = KERNEL_TOL[dtype]
            route = LA.fwd_route(dtype, q.shape[3], q.shape[4])
            print(f"[kernels-lsh] {name} {str(dtype)[6:]}: "
                  + ", ".join(f"{key} {e:.3e}" for key, e in errs.items())
                  + f", lse {lse_err:.3e}; tol {tol:g}; K4 (route "
                  f"{'tensor cores' if route else 'FMA'}"
                  f") twice bit-equal {same_fwd}, K5 {same}")
            _require(all(e <= tol for e in errs.values()) and lse_err <= 1e-5,
                     f"K4/K5 {name} disagree with their plain versions")
            _require(same and same_fwd, f"K4/K5 {name} is not deterministic")
            main.setdefault("lsh_attend", _abs_err(out, want))
            main.setdefault("lsh_attend_bwd", max(
                _abs_err(got[key], ref[key]) for key in ("dq", "dk", "dv")))
            del out, lse, out2, lse2, grads, again, want, wants, got, ref
    torch.cuda.empty_cache()
    return main


_LSH_KERNELS = (lsh_attend_fwd, lsh_attend_bwd, sort_by_bucket)
# launches of K4 (by q's shape), K6 (by x's) and K7's path entry (by the
# buckets') over a train phase's three steps, recorded by phases 12 and 16
# for the timing phases
SHAPE_LAUNCHES = {}


@contextlib.contextmanager
def _shape_tally(module, name: str):
    """Count the calls of ``module.name`` (a kernel wrapper, which the
    autograd Functions look up at call time) by the shape of their first
    argument, into the dict it yields.  The wrapper adds to its launch count through
    the same module name, so the count moves to the stand-in and back."""
    fn = getattr(module, name)
    tally = {}

    def counted(x, *args, **kwargs):
        tally[tuple(x.shape)] = tally.get(tuple(x.shape), 0) + 1
        return fn(x, *args, **kwargs)

    counted.launches = fn.launches
    setattr(module, name, counted)
    try:
        yield tally
    finally:
        fn.launches = counted.launches
        setattr(module, name, fn)


def _launches_per_step(kernel: str, shape) -> float:
    return SHAPE_LAUNCHES.get(kernel, {}).get(tuple(shape), 0) / 3


def _lsh_counts():
    return {"lsh_attend": lsh_attend_fwd.launches,
            "lsh_attend_bwd": lsh_attend_bwd.launches,
            "sort_by_bucket": sort_by_bucket.launches}


def phase_train_lsh():
    """Three longform_8k.yaml train steps at full width (b2, ragged up to
    1024 tokens and 8192 frames, bf16): finite loss, grad norm and
    gradients; per step 12 launches of K4, K5 and K7's path entry (6
    encoder + 6 decoder LSH self-attention layers) and 6 of K1 and of each
    K3 kernel (the decoder's cross-attention); K4's and K7's counted by
    shape.  Returns the model and the launch counts of K4, K5, K7 and K1
    (as "flash_cross")."""
    cfg = train_config(base=LONGFORM_CONFIG)
    torch.cuda.reset_peak_memory_stats()
    model, state, step_fn = _trainer(cfg, "cuda")
    names = [n for n, _ in model.named_parameters()]
    batch = train_batch(cfg, LSH_TOKEN_LENS, LSH_FRAME_LENS, "cuda")
    n_lsh = cfg.model.encoder.num_layers + cfg.model.decoder.num_layers
    n_cross = cfg.model.decoder.num_layers
    _reset_train_counts()
    for fn in _LSH_KERNELS:
        fn.launches = 0
    t0 = time.perf_counter()
    with _shape_tally(LA, "lsh_attend_fwd") as k4_shapes, \
            _shape_tally(BS, "sort_by_bucket") as k7_shapes:
        steps = [step_fn(model, state, batch,
                         step_generator(SEED_TRAIN, step, "cuda"), step,
                         return_grads=True) for step in range(3)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {**_train_counts(), **_lsh_counts()}
    SHAPE_LAUNCHES["lsh_attend"] = k4_shapes
    SHAPE_LAUNCHES["sort_by_bucket"] = k7_shapes
    for step, (metrics, grads) in enumerate(steps):
        _check_step(cfg, metrics, grads, names, f"LSH train step {step}")
        print(f"[train-lsh] step {step}: loss {float(metrics['loss']):.6f}, "
              f"grad_norm {float(metrics['grad_norm']):.6f}")
    print(f"[train-lsh] longform_8k.yaml b{len(LSH_TOKEN_LENS)} tokens "
          f"{list(LSH_TOKEN_LENS)} frames {list(LSH_FRAME_LENS)} bf16: 3 steps "
          f"in {dt:.2f} s (the first one cold); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches}; K4's by (B, H, chunks, c, dh): {k4_shapes}; K7's "
          f"by the buckets' (B, H, nh, L): {k7_shapes}")
    want = {"lsh_attend": 3 * n_lsh, "lsh_attend_bwd": 3 * n_lsh,
            "sort_by_bucket": 3 * n_lsh,
            "flash_train": 3 * n_cross, "flash_bwd_dkv": 3 * n_cross,
            "flash_bwd_dq": 3 * n_cross}
    _require(launches == want, f"expected launches {want} over 3 steps, got "
             f"{launches}")
    del steps
    return model, {"flash_cross": launches["flash_train"], **_lsh_counts()}


def _rotation_draws():
    """A stand-in for ``draw_rotations`` that draws the n-th call's
    rotations from a CPU generator seeded n, on whatever device: the card
    and the CPU then hash with the same rotations."""
    calls = [0]

    def draw(h, d, n_hashes, half, generator, device):
        g = torch.Generator().manual_seed(SEED_DATA + calls[0])
        calls[0] += 1
        return torch.randn((h, d, n_hashes, half), generator=g).to(device)

    return draw


def phase_train_lsh_card_vs_cpu():
    """One f32 longform step at 2 + 2 layers, every dropout 0, constant lr,
    on the card (K4/K5, K1/K3) and on the CPU (their plain versions) from
    the same weights, batch and rotations.  The CPU hashes for itself, to
    count the buckets that agree, and then attends with the card's buckets,
    so that a flipped near-tie does not move the comparison."""
    cfg = train_config("float32", num_layers=2, dropout_off=True,
                       base=LONGFORM_CONFIG, schedule="constant")
    launches = _lsh_step_card_vs_cpu(cfg, ((256, 180), (1024, 700)),
                                     "train-lsh", 4)
    _require(all(n > 0 for n in launches.values()),
             f"the card's step ran {launches}")


def _lsh_step_card_vs_cpu(cfg: Config, lens, tag: str, n_hashed: int):
    """One f32 step of ``cfg`` (an LSH model) on the card and on the CPU
    from the same weights, batch (lengths ``lens``) and rotations; the CPU
    hashes for itself, to count the buckets that agree, and then attends
    with the card's buckets, so that a flipped near-tie does not move the
    comparison.  ``n_hashed``: the LSH layers the step must hash.  Returns
    the card's launches of K1, K3, K4, K5 and K7."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr = cfg.experiment.optim.learning_rate
    batch = train_batch(cfg, *lens, "cpu")
    hash_vectors, draw_rotations = TL.hash_vectors, TL.draw_rotations
    card_buckets, agree = [], []

    def card_hash(*args, **kw):
        buckets = hash_vectors(*args, **kw)
        card_buckets.append(buckets.cpu())
        return buckets

    def cpu_hash(*args, **kw):
        own, card = hash_vectors(*args, **kw), card_buckets[len(agree)]
        agree.append(((own == card).sum().item(), own.numel()))
        return card

    try:
        TL.hash_vectors, TL.draw_rotations = card_hash, _rotation_draws()
        _reset_train_counts()
        for fn in _LSH_KERNELS:
            fn.launches = 0
        card = _f32_step(cfg, batch, "cuda")
        launches = {**_train_counts(), **_lsh_counts()}
        TL.hash_vectors, TL.draw_rotations = cpu_hash, _rotation_draws()
        t0 = time.perf_counter()
        cpu = _f32_step(cfg, batch, "cpu")
        t1 = time.perf_counter()
    finally:
        TL.hash_vectors, TL.draw_rotations = hash_vectors, draw_rotations
    equal, total = (sum(x) for x in zip(*agree))
    share = equal / total
    init = M.init(cfg.model, torch.Generator().manual_seed(SEED_TTS), "cpu")
    names = [n for n, _ in init.named_parameters()]
    loss_err = abs(card[0]["loss"] - cpu[0]["loss"]) / max(
        1.0, abs(cpu[0]["loss"]))
    norm_err = abs(card[0]["grad_norm"] - cpu[0]["grad_norm"]) / max(
        1.0, abs(cpu[0]["grad_norm"]))
    grad_errs = {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)
                     ).item() for n, a, b in zip(names, card[1], cpu[1])}
    worst = max(grad_errs, key=grad_errs.get)
    param_err = max((a - b).abs().max().item()
                    for a, b in zip(card[2], cpu[2]))
    print(f"[{tag}-card-vs-cpu] f32 2+2 layers b{len(lens[0])} tokens "
          f"{list(lens[0])} "
          f"frames {list(lens[1])}: buckets equal {equal}/{total} "
          f"({share:.6f}, min {BUCKET_SHARE_MIN}) over {len(agree)} LSH "
          f"layers; loss {card[0]['loss']:.6f} vs {cpu[0]['loss']:.6f} (err "
          f"{loss_err:.3e}), grad_norm err {norm_err:.3e}, worst gradient leaf "
          f"{worst} {grad_errs[worst]:.3e} (relative to its largest entry), "
          f"params after the update {param_err:.3e} (lr {lr:g}); tol "
          f"{TRAIN_SLICE_TOL:g}, params {TRAIN_PARAM_TOL_LR:g} lr; card "
          f"launches {launches} (cpu {t1 - t0:.1f} s)")
    _require(len(agree) == n_hashed
             and all(launches[k] > 0 for k in _lsh_counts()),
             f"the card's step ran {launches}, hashed {len(agree)} layers")
    _require(share >= BUCKET_SHARE_MIN, "card and CPU buckets disagree")
    _require(loss_err <= TRAIN_SLICE_TOL and norm_err <= TRAIN_SLICE_TOL
             and grad_errs[worst] <= TRAIN_SLICE_TOL
             and param_err <= TRAIN_PARAM_TOL_LR * lr,
             f"{tag}: card and CPU train steps disagree")
    return launches


def phase_train_lsh_timing(model):
    """The longform bf16 train step at b2 x 1024 tokens x 8192 frames, every
    position valid: best of 3 after a warm-up, one step under
    torch.profiler; K4 and K5 against their plain versions and bounds at
    the decoder and encoder shapes; the plain attend (use_pallas false)
    against K4 + K5, forward and backward, at both; K1 and K3 at the
    cross-attention's shape; the registers, shared memory and blocks an SM
    of K5's and K1's bf16 kernels."""
    cfg = train_config(base=LONGFORM_CONFIG)
    optimizer = make_optimizer(cfg.experiment.optim)
    state = optimizer.init(list(model.parameters()))
    step_fn = make_train_step(cfg.model, optimizer)
    b, n_tok, frames = 2, 1024, 8192
    batch = train_batch(cfg, (n_tok,) * b, (frames,) * b, "cuda")
    gen = torch.Generator(device="cuda")

    def step():
        metrics = step_fn(model, state, batch, gen.manual_seed(SEED_TRAIN),
                          state["count"])
        torch.cuda.synchronize()
        return metrics

    step()   # warm-up
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        metrics = step()
        walls.append(time.perf_counter() - t0)
        _require(bool(torch.isfinite(metrics["loss"])), "timed LSH step loss")
    best = min(walls)
    print(f"[train-lsh-timing] train step b{b} x {n_tok} tokens x {frames} "
          f"frames (longform_8k.yaml, bf16): walls "
          f"{[round(w, 4) for w in walls]} s; best {best:.4f} s = "
          f"{b * frames / best:.0f} frames/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    wall, busy, n_kernels, ops = _profile(step, top=8)
    print(f"[train-lsh-timing] profile of one step: wall {wall:.4f} s, device "
          f"busy {busy:.4f} s, idle {1 - busy / wall:.1%}; {n_kernels} device "
          f"activities; device time by op: {ops}")

    times = {}
    for name, n in ((_LSH_DECODER, 10), (_LSH_ENCODER, 50)):
        case = LSH_CASES[name]
        (q, k, v, dout), pos, valid, dlse, opts = _lsh_case(*case,
                                                            torch.bfloat16)
        fwd = _kernel_ms(lambda: lsh_attend_fwd(q, k, v, pos, valid, *opts),
                         lambda: lsh_attend_chunks_reference(
                             q, k, v, pos, valid, *opts), n)
        bwd = _kernel_ms(
            lambda: lsh_attend_bwd(q, k, v, pos, valid, dout, dlse, *opts),
            lambda: lsh_attend_bwd_reference(q, k, v, pos, valid, dout, dlse,
                                             *opts), n)

        def fwd_bwd(attend):
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            out, lse = attend(qq, kk, vv, pos, valid, *opts)
            torch.autograd.backward((out, lse), (dout, dlse))

        both = _kernel_ms(lambda: fwd_bwd(lsh_attend_chunks_kernel),
                          lambda: fwd_bwd(TL.plain_attend), n)
        dev = [_device_ms(lambda: lsh_attend_fwd(q, k, v, pos, valid, *opts),
                          n, ("lsh_attend_fwd_mma",)),
               _device_ms(lambda: lsh_attend_bwd(q, k, v, pos, valid, dout,
                                                 dlse, *opts),
                          n, ("lsh_bwd_dq", "lsh_bwd_dkv"))]
        bounds = _lsh_bounds(*case, torch.bfloat16)
        per_step = _launches_per_step("lsh_attend", q.shape)
        print(f"[train-lsh-timing] {name} bf16: K4 {fwd[0]:.4f} ms (device "
              f"{dev[0]:.4f}; {per_step:g} launches a longform step; plain "
              f"{fwd[1]:.4f}, bound {bounds['fwd']['bound_ms']:.4f} "
              f"{bounds['fwd']['bound_by']}); K5 {bwd[0]:.4f} ms (device "
              f"{dev[1]:.4f}; plain "
              f"{bwd[1]:.4f}, bound {bounds['bwd']['bound_ms']:.4f} "
              f"{bounds['bwd']['bound_by']}); forward + backward: K4 + K5 "
              f"{both[0]:.4f} ms, the plain attend (use_pallas false) "
              f"{both[1]:.4f} ms")
        times.setdefault("lsh_attend", dict(
            ms=fwd[0], plain_ms=fwd[1], device_ms=dev[0], library_ms=None,
            **bounds["fwd"]))
        times.setdefault("lsh_attend_bwd", dict(
            ms=bwd[0], plain_ms=bwd[1], device_ms=dev[1], library_ms=None,
            **bounds["bwd"]))
        del q, k, v, dout, pos, valid, dlse
        torch.cuda.empty_cache()
    c, _, before, after = LSH_CASES[_LSH_DECODER][4:8]
    _print_resources("train-lsh-timing", ("K4",),
                     "rtts_lsh_attend_fwd_resources", 64, c,
                     before + 1 + after)
    _print_resources("train-lsh-timing", ("K5 dQ kernel", "K5 dK/dV kernel"),
                     "rtts_lsh_attend_bwd_resources", 64, c,
                     before + 1 + after)
    times["cross"] = _flash_times(LONGFORM_CROSS, 10, "train-lsh-timing",
                                  sdpa=True)
    _print_resources("train-lsh-timing", ("K1",), "rtts_flash_fwd_resources",
                     64)
    torch.cuda.empty_cache()
    return times


# -- reversible training with the chunked FFN and K6 (configs/serving_fast.yaml)

# configs/serving_fast.yaml as a dict (tests/test_torch_guards.py holds the
# two equal)
_SERVING_FAST_ATTENTION = {"kind": "lsh", "num_heads": 8, "head_dim": 64,
                           "num_hashes": 4, "chunk_length": 64}
_SERVING_FAST_STACK = {"num_layers": 6, "d_model": 512, "d_ff": 2048,
                       "ffn_chunk_size": 256, "reversible": True}
SERVING_FAST_CONFIG = {
    "dataset": {"data_dir": "data", "batch_size": 8, "num_workers": 4,
                "max_mel_len": 1024},
    "model": {
        "d_model": 512,
        "n_mels": 80,
        "encoder": dict(_SERVING_FAST_STACK, causal=False,
                        attention=dict(_SERVING_FAST_ATTENTION)),
        "decoder": dict(_SERVING_FAST_STACK, causal=True,
                        attention=dict(_SERVING_FAST_ATTENTION)),
        "compute_dtype": "bfloat16",
        "kv_cache_dtype": "float8_e4m3fn",
    },
    "vocoder": {"n_flows": 12, "n_group": 128, "n_early_every": 4,
                "n_early_size": 16, "wn_layers": 8, "wn_channels": 128},
}
K6_ON = {"use_pallas_ffn": True}

K6_CASES = {
    # name: (rows, d, d_ff, activation)
    "decoder 8x1024 rows 512->2048 gelu": (8 * 1024, 512, 2048, "gelu"),
    "encoder 8x256 rows 512->2048 gelu": (8 * 256, 512, 2048, "gelu"),
    "ragged 8x1000+13 rows 512->2048 gelu": (8 * 1000 + 13, 512, 2048, "gelu"),
    **{f"narrow 1037 rows 96->200 {act}": (1037, 96, 200, act)
       for act in ("relu", "gelu", "tanh", "silu")},
}
_K6_DECODER = list(K6_CASES)[0]


def _k6_case(rows, d, f, act):
    """f32 rows and FFN parameters of the init's scales (LN and biases
    perturbed, so every term counts), on the card."""
    g = torch.Generator().manual_seed(SEED_DATA)
    x = torch.randn(rows, d, generator=g)
    params = (1.0 + 0.1 * torch.randn(d, generator=g),
              0.1 * torch.randn(d, generator=g),
              torch.randn(d, f, generator=g) * d ** -0.5,
              0.1 * torch.randn(f, generator=g),
              torch.randn(f, d, generator=g) * f ** -0.5,
              0.1 * torch.randn(d, generator=g))
    return x.cuda(), [t.cuda() for t in params], act


def _k6_bound(rows, d, f, act):
    """x read and out written in f32, the f32 weights and biases read once;
    the two products' 4 rows d f operations at the bf16 tensor-core rate."""
    n_bytes = 4 * (2 * rows * d + 2 * d * f + f + 3 * d)
    return _bound(n_bytes, 4 * rows * d * f, torch.bfloat16)


def phase_kernels_ffn():
    """K6 against its plain version run on the same inputs, multiplying in
    bf16 and in f32, at the stacks' shapes, a ragged row count and a narrow
    width with each activation; twice, bit-equal.  Returns the max abs
    error at the decoder shape in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    main = {}
    for name, case in K6_CASES.items():
        x, params, act = _k6_case(*case)
        for mxu in (torch.bfloat16, torch.float32):
            got = ffn_fused(x, *params, act, mxu)
            again = ffn_fused(x, *params, act, mxu)
            torch.cuda.synchronize()
            want = ffn_fused_reference(x, *params, act, mxu)
            err, same = _scaled_err(got, want), torch.equal(got, again)
            tol = KERNEL_TOL[mxu]
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            route = CF.ffn_route(mxu, *x.shape, sms)
            print(f"[kernels-ffn] K6 {name} multiply {str(mxu)[6:]} ("
                  + (f"tensor cores, {route} rows a block" if route else
                     "FMA") + f"): max err {err:.3e} (abs "
                  f"{_abs_err(got, want):.3e}), tol {tol:g}; twice bit-equal "
                  f"{same}")
            _require(err <= tol, f"K6 {name} disagrees with its plain version")
            _require(same, f"K6 {name} is not deterministic")
            main.setdefault("ffn_fused", _abs_err(got, want))
    return main


def _serving_fast_counts():
    return {**_train_counts(), **_lsh_counts(),
            "ffn_fused": ffn_fused.launches}


def _reset_all_counts():
    for fn in (*_TRAIN_KERNELS, *_LSH_KERNELS, ffn_fused):
        fn.launches = 0


def phase_train_serving_fast():
    """Three serving_fast.yaml train steps at full width (b8, ragged up to
    256 tokens and 1024 frames, bf16), reversible residuals with K6 on every
    FFN, then three as shipped (the chunked FFN, no K6): finite loss, grad
    norm and nonzero gradients, and per step the launches the code implies.
    Returns the K6 model and the launch counts of its three steps."""
    result = None
    for k6 in (True, False):
        cfg = train_config(base=SERVING_FAST_CONFIG,
                           stack_overrides=K6_ON if k6 else None)
        enc, dec = cfg.model.encoder.num_layers, cfg.model.decoder.num_layers
        n_ffn, n_lsh, n_cross = enc + 2 * dec, enc + dec, dec
        model, state, step_fn = _trainer(cfg, "cuda")
        names = [n for n, _ in model.named_parameters()]
        batch = train_batch(cfg, TRAIN_TOKEN_LENS, TRAIN_FRAME_LENS, "cuda")
        torch.cuda.reset_peak_memory_stats()
        _reset_all_counts()
        t0 = time.perf_counter()
        with _shape_tally(LA, "lsh_attend_fwd") as k4_shapes, \
                _shape_tally(CF, "ffn_fused") as k6_shapes, \
                _shape_tally(BS, "sort_by_bucket") as k7_shapes:
            steps = [step_fn(model, state, batch,
                             step_generator(SEED_TRAIN, step, "cuda"), step,
                             return_grads=True) for step in range(3)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = _serving_fast_counts()
        what = "K6" if k6 else "as shipped"
        if k6:
            SHAPE_LAUNCHES["serving_fast lsh_attend"] = k4_shapes
            SHAPE_LAUNCHES["ffn_fused"] = k6_shapes
            SHAPE_LAUNCHES["serving_fast sort_by_bucket"] = k7_shapes
        for step, (metrics, grads) in enumerate(steps):
            _check_step(cfg, metrics, grads, names,
                        f"serving_fast {what} step {step}")
            print(f"[train-rev] {what} step {step}: loss "
                  f"{float(metrics['loss']):.6f}, grad_norm "
                  f"{float(metrics['grad_norm']):.6f}")
        # per step: each FFN in the forward and again in the reconstruction;
        # each LSH layer K4 and K7 in the forward and in the recompute (from
        # the cached buckets), K5 once; each cross-attention K1 twice, each
        # K3 kernel once
        per_step = {"flash_train": 2 * n_cross, "flash_bwd_dkv": n_cross,
                    "flash_bwd_dq": n_cross, "lsh_attend": 2 * n_lsh,
                    "lsh_attend_bwd": n_lsh, "sort_by_bucket": 2 * n_lsh,
                    "ffn_fused": 2 * n_ffn if k6 else 0}
        print(f"[train-rev] serving_fast.yaml {what} b{len(TRAIN_TOKEN_LENS)} "
              f"tokens {list(TRAIN_TOKEN_LENS)} frames "
              f"{list(TRAIN_FRAME_LENS)} bf16: 3 steps in {dt:.2f} s (the "
              f"first one cold); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
              f"per step {({k: v / 3 for k, v in launches.items()})}; over 3 "
              f"steps K4's by (B, H, chunks, c, dh) {k4_shapes}, K6's by "
              f"(rows, d) {k6_shapes}, K7's by (B, H, nh, L) {k7_shapes}")
        want = {k: 3 * v for k, v in per_step.items()}
        _require(launches == want, f"serving_fast {what}: expected launches "
                 f"{want} over 3 steps, got {launches}")
        del steps
        if k6:
            result = model, {"ffn_fused": launches["ffn_fused"]}
        else:
            del model, state
    torch.cuda.empty_cache()
    return result


# reversible vs plain residuals: the CPU test's tolerance (JAX's own
# reversible-vs-plain test, tests/test_model_lsh.py): the reconstruction
# X2 = Y2 - g(Y1) rounds in f32, layer after layer
REV_TOL = 5e-4


def phase_train_serving_fast_card_vs_cpu():
    """One f32 serving_fast step at 2 + 2 layers, every dropout 0, constant
    lr: the card with K6 against the CPU with K6's plain version (the gate
    forced there), from the same weights, batch and rotations, buckets
    counted as in phase 13.  Then, on the card, reversible against plain
    residuals from one generator with dropout on: the loss and every
    gradient within the CPU test's tolerance, nonzero where plain's is."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_config("float32", num_layers=2, dropout_off=True,
                       base=SERVING_FAST_CONFIG, stack_overrides=K6_ON,
                       schedule="constant")
    lr = cfg.experiment.optim.learning_rate
    lens = ((256, 180), (512, 400))
    batch = train_batch(cfg, *lens, "cpu")
    hash_vectors, draw_rotations = TL.hash_vectors, TL.draw_rotations
    gate = TS.use_ffn_kernel
    card_buckets, agree = [], []

    def card_hash(*args, **kw):
        buckets = hash_vectors(*args, **kw)
        card_buckets.append(buckets.cpu())
        return buckets

    def cpu_hash(*args, **kw):
        own, card = hash_vectors(*args, **kw), card_buckets[len(agree)]
        agree.append(((own == card).sum().item(), own.numel()))
        return card

    try:
        TL.hash_vectors, TL.draw_rotations = card_hash, _rotation_draws()
        _reset_all_counts()
        card = _f32_step(cfg, batch, "cuda")
        launches = _serving_fast_counts()
        TL.hash_vectors, TL.draw_rotations = cpu_hash, _rotation_draws()
        TS.use_ffn_kernel = lambda x: True
        t0 = time.perf_counter()
        cpu = _f32_step(cfg, batch, "cpu")
        t1 = time.perf_counter()
    finally:
        TL.hash_vectors, TL.draw_rotations = hash_vectors, draw_rotations
        TS.use_ffn_kernel = gate
    equal, total = (sum(x) for x in zip(*agree))
    share = equal / total
    init = M.init(cfg.model, torch.Generator().manual_seed(SEED_TTS), "cpu")
    names = [n for n, _ in init.named_parameters()]
    loss_err = abs(card[0]["loss"] - cpu[0]["loss"]) / max(
        1.0, abs(cpu[0]["loss"]))
    norm_err = abs(card[0]["grad_norm"] - cpu[0]["grad_norm"]) / max(
        1.0, abs(cpu[0]["grad_norm"]))
    grad_errs = {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)
                     ).item() for n, a, b in zip(names, card[1], cpu[1])}
    worst = max(grad_errs, key=grad_errs.get)
    param_err = max((a - b).abs().max().item()
                    for a, b in zip(card[2], cpu[2]))
    print(f"[train-rev-card-vs-cpu] f32 2+2 layers K6 b2 tokens "
          f"{list(lens[0])} frames {list(lens[1])}: buckets equal "
          f"{equal}/{total} ({share:.6f}, min {BUCKET_SHARE_MIN}) over "
          f"{len(agree)} LSH layers; loss {card[0]['loss']:.6f} vs "
          f"{cpu[0]['loss']:.6f} (err {loss_err:.3e}), grad_norm err "
          f"{norm_err:.3e}, worst gradient leaf {worst} {grad_errs[worst]:.3e}"
          f" (relative to its largest entry), params after the update "
          f"{param_err:.3e} (lr {lr:g}); tol {TRAIN_SLICE_TOL:g}, params "
          f"{TRAIN_PARAM_TOL_LR:g} lr; card launches {launches} (cpu "
          f"{t1 - t0:.1f} s)")
    _require(len(agree) == 4 and all(n > 0 for n in launches.values()),
             f"the card's step ran {launches}, hashed {len(agree)} layers")
    _require(share >= BUCKET_SHARE_MIN, "card and CPU buckets disagree")
    _require(loss_err <= TRAIN_SLICE_TOL and norm_err <= TRAIN_SLICE_TOL
             and grad_errs[worst] <= TRAIN_SLICE_TOL
             and param_err <= TRAIN_PARAM_TOL_LR * lr,
             "card and CPU reversible train steps disagree")

    runs = {}
    for rev in (True, False):
        cfg = train_config("float32", num_layers=2, base=SERVING_FAST_CONFIG,
                           stack_overrides=dict(K6_ON, reversible=rev),
                           schedule="constant")
        runs[rev] = _f32_step(cfg, batch, "cuda")
    (rev_m, rev_g, _), (plain_m, plain_g, _) = runs[True], runs[False]
    loss_err = abs(rev_m["loss"] - plain_m["loss"]) / abs(plain_m["loss"])
    scale = max(g.abs().max().item() for g in plain_g)
    grad_err = max((a - b).abs().max().item()
                   for a, b in zip(rev_g, plain_g)) / scale
    same_zeros = all(bool((a != 0).any()) == bool((b != 0).any())
                     for a, b in zip(rev_g, plain_g))
    print(f"[train-rev-card-vs-cpu] reversible vs plain on the card, f32 2+2 "
          f"layers K6, dropout on: loss {rev_m['loss']:.6f} vs "
          f"{plain_m['loss']:.6f} (rel err {loss_err:.3e}), max gradient "
          f"difference {grad_err:.3e} of the largest entry (tol {REV_TOL:g}); "
          f"nonzero where plain's are: {same_zeros}")
    _require(loss_err <= 1e-5 and grad_err <= REV_TOL and same_zeros,
             "reversible and plain residuals disagree on the card")



# the reversible step's peak device memory must stay below this share of
# the plain step's: a backward that kept each layer's inputs would not
REV_PEAK_SHARE_MAX = 0.6


def _ffn_held_and_peak(chunk: int, b: int = 8, frames: int = 1024):
    """One bf16 FFN sublayer at the decoder's shape through ``chunked_ffn``:
    the device memory autograd holds after the forward and the peak of
    forward + backward, both beyond the input, in MiB."""
    p = FFN(512, 2048, generator=torch.Generator().manual_seed(SEED_DATA),
            device="cuda")
    x = torch.randn(b, frames, 512, device="cuda", requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = chunked_ffn(p, x, chunk, "gelu", torch.bfloat16)
    held = torch.cuda.memory_allocated() - base
    out.float().sum().backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del p, x, out
    torch.cuda.empty_cache()
    return held / 2**20, peak / 2**20


def phase_train_serving_fast_timing(model):
    """The bf16 serving_fast train step at b8 x 256 tokens x 1024 frames,
    every position valid, in four variants: reversible + K6, reversible +
    the chunked FFN (as shipped), reversible with an unchunked FFN and
    plain residuals with an unchunked FFN.  Each: best of 3 after a
    warm-up, peak device memory reset before each step, and one profiled
    step; the reversible peaks below ``REV_PEAK_SHARE_MAX`` of the plain
    one.  One FFN sublayer chunked and unchunked: what autograd holds.  K6
    at the decoder's and the encoder's FFN shapes against its plain
    version, its bound and the unfused bf16 FFN, with its launches a step
    and the runtime's resources of its kernels; K4 at serving_fast's two
    LSH shapes against its plain version and bound, with its launches a
    step.  Returns K6's times at the decoder's shape."""
    b, n_tok, frames = 8, 256, 1024
    plain = "plain residuals, unchunked FFN"
    variants = {"reversible + K6": K6_ON,
                "reversible + chunked FFN (as shipped)": {},
                "reversible, unchunked FFN": {"ffn_chunk_size": 0},
                plain: {"reversible": False, "ffn_chunk_size": 0}}
    params = list(model.parameters())
    best_peak = {}
    for name, overrides in variants.items():
        cfg = train_config(base=SERVING_FAST_CONFIG, stack_overrides=overrides)
        optimizer = make_optimizer(cfg.experiment.optim)
        state = optimizer.init(params)
        step_fn = make_train_step(cfg.model, optimizer)
        batch = train_batch(cfg, (n_tok,) * b, (frames,) * b, "cuda")
        gen = torch.Generator(device="cuda")

        def step():
            metrics = step_fn(model, state, batch,
                              gen.manual_seed(SEED_TRAIN), state["count"])
            torch.cuda.synchronize()
            return metrics

        step()   # warm-up
        walls, peaks = [], []
        for _ in range(3):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            metrics = step()
            walls.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            _require(bool(torch.isfinite(metrics["loss"])),
                     f"timed serving_fast step loss ({name})")
        best = min(walls)
        best_peak[name] = min(peaks)
        print(f"[train-rev-timing] {name}: train step b{b} x {n_tok} tokens x "
              f"{frames} frames (serving_fast.yaml, bf16): walls "
              f"{[round(w, 4) for w in walls]} s; best {best:.4f} s = "
              f"{b * frames / best:.0f} frames/s; peak device memory "
              f"{[round(p, 3) for p in peaks]} GiB")
        wall, busy, n_kernels, ops = _profile(step, top=8)
        print(f"[train-rev-timing] profile of one {name} step: wall "
              f"{wall:.4f} s, device busy {busy:.4f} s, idle "
              f"{1 - busy / wall:.1%}; {n_kernels} device activities; "
              f"device time by op: {ops}")
        del state, step_fn, batch
        torch.cuda.empty_cache()
    for name, peak in best_peak.items():
        if name != plain:
            share = peak / best_peak[plain]
            print(f"[train-rev-timing] peak device memory {name} / plain: "
                  f"{share:.3f} (max {REV_PEAK_SHARE_MAX})")
            _require(share < REV_PEAK_SHARE_MAX,
                     f"the {name} step's peak memory is not below "
                     f"{REV_PEAK_SHARE_MAX} of the plain step's")
    held = {chunk: _ffn_held_and_peak(chunk) for chunk in (256, 0)}
    print(f"[train-rev-timing] one bf16 FFN sublayer b{b} x {frames} x 512 -> "
          f"2048: held by autograd after the forward chunked (256) "
          f"{held[256][0]:.1f} MiB vs unchunked {held[0][0]:.1f} MiB; peak of "
          f"forward + backward {held[256][1]:.1f} vs {held[0][1]:.1f} MiB")
    _require(held[256][0] < held[0][0], "the chunked FFN's checkpoint holds as "
             "much as the unchunked FFN")

    times = {}
    bf = torch.bfloat16
    for name in list(K6_CASES)[:2]:   # the decoder's and the encoder's FFN
        case = K6_CASES[name]
        x, k6_params, act = _k6_case(*case)
        kernel = lambda: ffn_fused(x, *k6_params, act, bf)  # noqa: E731
        ms = _kernel_ms(
            kernel, lambda: ffn_fused_reference(x, *k6_params, act, bf), 20)
        dev = _device_ms(kernel, 20, ("ffn_fused_cast", "ffn_fused_mma"))
        bound = _k6_bound(*case)
        unfused = _interleaved_ms((kernel, _unfused_ffn(x, k6_params, act)),
                                  50, cycles=1)
        per_step = _launches_per_step("ffn_fused", x.shape)
        print(f"[train-rev-timing] K6 {name} multiply bf16: kernel "
              f"{ms[0]:.4f} ms (device {dev:.4f}; {per_step:g} launches a "
              f"serving_fast + K6 step), plain {ms[1]:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); no single "
              f"PyTorch call computes LN -> dense -> act -> dense")
        print(f"[train-rev-timing] K6 {name} against the unfused bf16 FFN "
              f"(F.layer_norm, bf16 torch.matmul, the activation, bf16 "
              f"torch.matmul; a yardstick, not one call): K6 "
              f"{unfused[0]:.4f} ms, unfused {unfused[1]:.4f} ms")
        times.setdefault("ffn_fused", dict(ms=ms[0], plain_ms=ms[1],
                                           device_ms=dev, library_ms=None,
                                           **bound))
    d = K6_CASES[_K6_DECODER][1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for rows in sorted({CF.ffn_route(bf, K6_CASES[name][0], d, sms)
                        for name in list(K6_CASES)[:2]}, reverse=True):
        _print_resources("train-rev-timing", (f"K6 at {rows} rows a block",),
                         "rtts_ffn_fused_resources", rows, CF._pad(d))

    # K4 at serving_fast's two LSH shapes, with its launches a step (the
    # longform shapes are phase 14's)
    for name in [n for n in LSH_CASES if n.startswith("serving_fast")]:
        case = LSH_CASES[name]
        (q, k, v, _), pos, valid, _, opts = _lsh_case(*case, bf)
        ms = _kernel_ms(lambda: lsh_attend_fwd(q, k, v, pos, valid, *opts),
                        lambda: lsh_attend_chunks_reference(q, k, v, pos,
                                                            valid, *opts), 20)
        dev = _device_ms(lambda: lsh_attend_fwd(q, k, v, pos, valid, *opts),
                         20, ("lsh_attend_fwd_mma",))
        bound = _lsh_bounds(*case, bf)["fwd"]
        per_step = _launches_per_step("serving_fast lsh_attend", q.shape)
        print(f"[train-rev-timing] {name} bf16: K4 {ms[0]:.4f} ms (device "
              f"{dev:.4f}; {per_step:g} launches a serving_fast step; plain "
              f"{ms[1]:.4f}, bound {bound['bound_ms']:.4f} "
              f"{bound['bound_by']})")
        del q, k, v, pos, valid
    torch.cuda.empty_cache()
    return times


def _unfused_ffn(x, params, act):
    """The FFN in plain PyTorch ops at bf16 multiplies: LayerNorm in f32,
    the two products by bf16 torch.matmul (cuBLAS), the activation between;
    the weights cast each call, as the model's forward does."""
    ln_scale, ln_bias, w_in, b_in, w_out, b_out = params
    fn = activation(act)

    def run():
        h = F.layer_norm(x.float(), (x.shape[-1],), ln_scale, ln_bias,
                         CF.EPS).to(torch.bfloat16)
        mid = fn(torch.matmul(h, w_in.to(torch.bfloat16)).float() + b_in)
        out = torch.matmul(mid.to(torch.bfloat16), w_out.to(torch.bfloat16))
        return (out.float() + b_out).to(x.dtype)

    return run


# -- the sort probe: K7, K8 and the one-hot sort gather ----------------------------

K7_CASES = {
    # name: (rows, columns, packed LSH keys of the probe's shape or None)
    "probe L4096 C128 packed keys": (4096, 128, "probe L4096 C128"),
    "longform L8192 C64 packed keys": (8192, 64, "longform b2 h8 nh4 L8192"),
    "serving_fast L1024 C256 packed keys": (1024, 256,
                                            "serving_fast b8 h8 nh4 L1024"),
    "wide 1024 x 2048 (8 columns a block)": (1024, 2048, None),
    f"most rows {MAX_ROWS} x 4": (MAX_ROWS, 4, None),
}
K8_CASES = {
    # name: (rows, width, indices, dtype)
    "probe 4096 rows d128 f32": (4096, 128, 4096, torch.float32),
    "probe 4096 rows d256 f32": (4096, 256, 4096, torch.float32),
    "longform 16 x 8192 rows d128 bf16, 4 rounds": (
        16 * 8192, 128, 4 * 16 * 8192, torch.bfloat16),
    "serving_fast 64 x 1024 rows d128 bf16, 4 rounds": (
        64 * 1024, 128, 4 * 64 * 1024, torch.bfloat16),
    "d3 f32 (12-byte rows), repeats": (1000, 3, 2500, torch.float32),
    "d5 bf16 (10-byte rows), repeats": (1000, 5, 2500, torch.bfloat16),
    "d100 bf16 (200-byte rows)": (4096, 100, 4096, torch.bfloat16),
}
SORT_PATH_CASES = {
    # name: (the buckets' shape, batch rows padded whole); each batch row
    # else padded from a random length on (the overflow bucket)
    "longform decoder (2, 8, 4, 8192)": ((2, 8, 4, 8192), 0),
    "longform encoder (2, 8, 4, 1024)": ((2, 8, 4, 1024), 0),
    "serving_fast decoder (8, 8, 4, 1024), one row padded whole": (
        (8, 8, 4, 1024), 1),
    "serving_fast encoder (8, 8, 4, 256), one row padded whole": (
        (8, 8, 4, 256), 1),
    "L 960 (2, 3, 2, 960)": ((2, 3, 2, 960), 0),
    "L 5000, one CTA a row (3, 2, 25, 5000)": ((3, 2, 25, 5000), 0),
    f"most keys (2, 1, 2, {MAX_ROWS})": ((2, 1, 2, MAX_ROWS), 0),
}
_SORT_LONGFORM = list(SORT_PATH_CASES)[0]
# the four shapes the LSH train steps give K7's path entry
SORT_PATH_SHAPES = list(SORT_PATH_CASES)[:4]


def _bucket_case(shape, masked_rows=0, seed=SEED_DATA, device="cuda"):
    """Buckets (B, H, nh, L) int64 in [0, nb] as ``hash_vectors`` gives
    them, nb the auto count at chunk 64 and itself the overflow bucket of
    padding: each batch row valid up to a random length of at least L / 2,
    the last ``masked_rows`` padded whole."""
    g = torch.Generator().manual_seed(seed)
    b, l = shape[0], shape[-1]
    nb = TL.auto_num_buckets(l, 64)
    buckets = torch.randint(0, nb, shape, generator=g)
    lens = torch.randint(l // 2, l + 1, (b,), generator=g)
    lens[b - masked_rows:] = 0
    pad = torch.arange(l)[None, :] >= lens[:, None]
    return torch.where(pad[:, None, None, :], nb, buckets).to(device)


# onehot against take on the card, relative to max(1, |take|).  f32: the
# forward bit-equal (one matched element per one-hot row, and the combine's
# rounded products summed round by round in both modes); the gradients
# 1e-6 (the one-hot matmuls' backward against the inverse gathers may sum
# in another order).  bf16: the forward 1e-2 (KERNEL_TOL); the gradients
# 4 bf16 ulps (4 x 2^-7): onehot rounds the weighted outputs and the
# unsort's cotangents to bf16 where take combines and unsorts in f32 (the
# reference's design), and the attention backward carries that on
ONEHOT_GRAD_TOL = {torch.float32: 1e-6, torch.bfloat16: 4 * 2.0 ** -7}


def _k7_case(n, cols, shape):
    """Packed LSH keys, or int32 keys over the whole range with duplicates
    and both extremes."""
    if shape is not None:
        return probe.lsh_buckets(*probe.SHAPES[shape])[1]
    g = torch.Generator().manual_seed(SEED_DATA)
    x = torch.randint(-2**31, 2**31 - 1, (n, cols), generator=g,
                      dtype=torch.int64).int()
    x[: n // 4] = x[n // 2: n // 2 + n // 4]
    x[0, 0], x[1, 0] = -2**31, 2**31 - 1
    return x.cuda()


def _k8_case(rows, d, m, dtype):
    """Rows and indices: ``m // rows`` permutations of the rows (the LSH
    path's rounds), or ``m`` draws with repeats."""
    g = torch.Generator().manual_seed(SEED_DATA)
    x = torch.randn(rows, d, generator=g).to("cuda", dtype)
    if m % rows == 0:
        idx = torch.cat([torch.randperm(rows, generator=g)
                         for _ in range(m // rows)])
    else:
        idx = torch.randint(0, rows, (m,), generator=g)
    return x, idx.int().cuda()


def phase_kernels_sort():
    """K7's path entry against its plain version at the LSH train steps'
    four shapes, a length that is not a power of two, one CTA a row and the
    most keys; K7's column entry and K8 against their plain versions and
    the library calls at the sort probe's shapes: equal (they move values;
    tolerance 0), and twice bit-equal.  Returns their max abs errors at the
    longform shapes."""
    errs = {}
    for name, (shape, masked) in SORT_PATH_CASES.items():
        buckets = _bucket_case(shape, masked)
        got, again = sort_by_bucket(buckets), sort_by_bucket(buckets)
        torch.cuda.synchronize()
        want = sort_by_bucket_reference(buckets)
        err = max(_abs_err(g, w) for g, w in zip(got, want))
        ok = err == 0 and all(torch.equal(g, w) and g.dtype == w.dtype
                              for g, w in zip(got, want))
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        route = BS.sort_route(buckets.numel() // shape[-1], shape[-1],
                              BS._sm_count(0))
        print(f"[kernels-sort] K7 sort_by_bucket {name} (CTAs a row, rows a "
              f"block: {route}): max abs err {err:g} (tol 0) over "
              f"sorted_pos, undo_idx, sorted_buckets; equal, int64, {ok}; "
              f"twice bit-equal {same}")
        _require(ok, f"K7 sort_by_bucket {name} disagrees with its plain "
                 "version")
        _require(same, f"K7 sort_by_bucket {name} is not deterministic")
        if name == _SORT_LONGFORM:
            errs["sort_by_bucket"] = err
        del buckets, got, again, want
    for name, case in K7_CASES.items():
        x = _k7_case(*case)
        got, again = bitonic_sort_cols(x), bitonic_sort_cols(x)
        torch.cuda.synchronize()
        want = bitonic_sort_cols_reference(x)
        err = _abs_err(got, want)
        ok = (err == 0 and torch.equal(got, want)
              and torch.equal(got, torch.sort(x, dim=0).values))
        print(f"[kernels-sort] K7 {name}: max abs err {err:g} (tol 0), equal "
              f"to torch.sort {ok}; twice bit-equal {torch.equal(got, again)}")
        _require(ok, f"K7 {name} disagrees with its plain version")
        _require(torch.equal(got, again), f"K7 {name} is not deterministic")
        if name.startswith("longform"):
            errs["bitonic_sort"] = err
    for name, case in K8_CASES.items():
        x, idx = _k8_case(*case)
        got, again = row_gather(x, idx), row_gather(x, idx)
        torch.cuda.synchronize()
        want = row_gather_reference(x, idx)
        err = _abs_err(got, want)
        ok = (err == 0 and torch.equal(got, want)
              and torch.equal(got, torch.index_select(x, 0, idx)))
        print(f"[kernels-sort] K8 {name}: max abs err {err:g} (tol 0), equal "
              f"to index_select {ok}; twice bit-equal "
              f"{torch.equal(got, again)}")
        _require(ok, f"K8 {name} disagrees with its plain version")
        _require(torch.equal(got, again), f"K8 {name} is not deterministic")
        if name.startswith("longform"):
            errs["row_gather"] = err
    return errs


def _onehot_vs_take(dtype):
    """``lsh_attention_core`` at serving_fast's decoder shape (b8 h8 nh4
    L1024 causal, the ragged train lengths, hashed from one seed) in both
    modes: (out, d qk, d v) of each."""
    b, h, nh, l = probe.SHAPES["serving_fast b8 h8 nh4 L1024"]
    g = torch.Generator().manual_seed(SEED_DATA)
    qk, v, cot = (torch.randn(b, h, l, 64, generator=g).to("cuda", dtype)
                  for _ in range(3))
    mask = (torch.arange(l)[None, :]
            < torch.tensor(TRAIN_FRAME_LENS)[:, None]).cuda()
    base = AttentionConfig(**_SERVING_FAST_ATTENTION)
    result = {}
    for mode in ("take", "onehot"):
        q, vv = (t.detach().requires_grad_() for t in (qk, v))
        out, _ = TL.lsh_attention_core(
            q, vv, dataclasses.replace(base, sort_gather=mode), mask, True,
            torch.Generator(device="cuda").manual_seed(SEED_DATA))
        result[mode] = (out, *torch.autograd.grad(out, (q, vv), cot))
    return result


def _sort_on_route(buckets, cluster: int):
    """K7's path entry with ``cluster`` CTAs a row and one row a block,
    whatever ``sort_route`` would pick."""
    route = BS.sort_route
    BS.sort_route = lambda rows, l, sms: (cluster, 1)
    try:
        return sort_by_bucket(buckets)
    finally:
        BS.sort_route = route


def _sort_path_times():
    """K7's path entry at the LSH train steps' four shapes against its
    plain version (``torch.sort`` + ``torch.argsort``), one
    ``torch.sort(keys, dim=-1)`` (values and indices, without the inverse)
    and its bound, with its launches a step.  Returns the times at the
    longform decoder's shape."""
    times = None
    for name in SORT_PATH_SHAPES:
        shape, masked = SORT_PATH_CASES[name]
        buckets = _bucket_case(shape, masked)
        l, rows = shape[-1], buckets.numel() // shape[-1]
        keys = buckets * l + torch.arange(l, device="cuda")
        fns = (lambda: sort_by_bucket(buckets),
               lambda: sort_by_bucket_reference(buckets),
               lambda: torch.sort(keys, dim=-1))
        ms = _interleaved_ms(fns, 100)
        dev = [_device_ms(fns[0], 50, ("BucketIO",)),
               _device_ms(fns[1], 50), _device_ms(fns[2], 50)]
        # bytes: the int64 buckets in, three int64 outputs; operations: the
        # compare-exchanges over the padded rows at the f32 rate outside
        # the tensor cores (the card's table has no integer row)
        work = probe.sort_bound(1 << (l - 1).bit_length(), rows)
        bound = _bound(rows * l * 4 * 8, work["ops"], torch.float32)
        per_step = (_launches_per_step("sort_by_bucket", shape)
                    or _launches_per_step("serving_fast sort_by_bucket",
                                          shape))
        print(f"[sort-path] K7 sort_by_bucket {name}: {ms[0]:.4f} ms (device "
              f"{dev[0]:.4f}; {per_step:g} launches a step); plain, torch.sort "
              f"+ argsort, {ms[1]:.4f} ms (device {dev[1]:.4f}); "
              f"torch.sort(keys, dim=-1) {ms[2]:.4f} ms (device "
              f"{dev[2]:.4f}); bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']})")
        if times is None:
            times = dict(ms=ms[0], plain_ms=ms[1], device_ms=dev[0],
                         library_ms=ms[2], **bound)
        del buckets, keys
    return times


def _sort_route_sweep(lengths=(1024, 2048, 4096, 8192, 16384, MAX_ROWS)):
    """K7's path entry on 64 rows (the longform steps' B H nh) of each
    length, one CTA a row against a 2-CTA cluster a row: device time of
    each, equal outputs, and the CTAs a row ``sort_route`` takes."""
    for l in lengths:
        buckets = _bucket_case((2, 8, 4, l))
        want = sort_by_bucket_reference(buckets)
        dev = []
        for cluster in (1, 2):
            got = _sort_on_route(buckets, cluster)
            _require(all(torch.equal(g, w) for g, w in zip(got, want)),
                     f"K7 sort_by_bucket (2, 8, 4, {l}) on {cluster} CTAs a "
                     "row disagrees with its plain version")
            run = functools.partial(_sort_on_route, buckets, cluster)
            dev.append(_device_ms(run, 50, ("BucketIO",)))
        print(f"[sort-path] K7 sort_by_bucket (2, 8, 4, {l}): device one CTA "
              f"a row {dev[0]:.4f} ms, a 2-CTA cluster a row {dev[1]:.4f} ms; "
              f"the route takes {BS.sort_route(64, l, BS._sm_count(0))[0]}")
        del buckets, want


def phase_sort_probe():
    """The probe's bench() with K7's and K8's counts set to 0 before it and
    read after it (each launched at least once); then onehot against take
    on the card; then K7's path entry at the LSH train steps' shapes.
    Returns the launch counts of the column entry and K8 and the kernels'
    times at the longform shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bitonic_sort_cols.launches = row_gather.launches = 0
    result = probe.bench()
    launches = {"bitonic_sort": bitonic_sort_cols.launches,
                "row_gather": row_gather.launches}
    print(f"[sort-probe] launches in the probe's run: {launches}")
    _require(all(n > 0 for n in launches.values()),
             f"the probe did not launch K7 and K8: {launches}")

    for dtype in (torch.float32, torch.bfloat16):
        got = _onehot_vs_take(dtype)
        errs = [_scaled_err(a, b) for a, b in zip(got["onehot"],
                                                  got["take"])]
        same = torch.equal(got["onehot"][0], got["take"][0])
        f32 = dtype == torch.float32
        tol = ONEHOT_GRAD_TOL[dtype]
        print(f"[sort-probe] lsh_attention_core serving_fast b8 h8 nh4 L1024 "
              f"causal, ragged, {str(dtype)[6:]}: onehot vs take out "
              f"{errs[0]:.3e} (bit-equal {same}), d qk {errs[1]:.3e}, d v "
              f"{errs[2]:.3e}; tol: out "
              + ("bit-equal" if f32 else f"{KERNEL_TOL[dtype]:g}")
              + f", gradients {tol:g}")
        _require((same if f32 else errs[0] <= KERNEL_TOL[dtype])
                 and max(errs[1:]) <= tol,
                 f"sort_gather onehot disagrees with take in {dtype}")
        del got
    torch.cuda.empty_cache()

    k7 = result["sort"]["longform b2 h8 nh4 L8192"]
    k8 = result["gather"]["longform (16, 32768, 128) bf16"]
    # their device time at the same shapes (after the launch counts above)
    keys = _k7_case(*K7_CASES["longform L8192 C64 packed keys"])
    x, idx = _k8_case(*K8_CASES["longform 16 x 8192 rows d128 bf16, 4 rounds"])
    dev = [_device_ms(lambda: bitonic_sort_cols(keys), 20, ("ColumnIO",)),
           _device_ms(lambda: row_gather(x, idx), 20, ("row_gather_kernel",))]
    print(f"[sort-probe] device time at the longform shapes: K7 "
          f"{dev[0]:.4f} ms, K8 {dev[1]:.4f} ms")
    # K7's bound: its compare-exchanges at the f32 rate outside the tensor
    # cores (the card's table has no integer row); K8 moves bytes only
    times = {"bitonic_sort": dict(ms=k7["K7"], plain_ms=k7["plain"],
                                  device_ms=dev[0],
                                  library_ms=k7["torch.sort"],
                                  **_bound(k7["bytes"], k7["ops"],
                                           torch.float32)),
             "row_gather": dict(ms=k8["K8"], plain_ms=k8["plain"],
                                device_ms=dev[1],
                                library_ms=k8["index_select"],
                                **_bound(k8["bytes"], 0, torch.bfloat16)),
             "sort_by_bucket": _sort_path_times()}
    _sort_route_sweep()
    return launches, times

# -- vocoder training (phases 21-25) -------------------------------------------

# configs/flagship.yaml's vocoder settings beside base.yaml's
FLAGSHIP_VOCODER = {"compute_dtype": "float32", "log_s_clamp": 5.0}
VOC_BATCH = 8              # rtts/bench.py::bench_vocoder_train's batch
VOC_SHAPE = (8, 128, 128)  # K2 in the train step: 16384 / 128 squeezed rows
# the reduced vocoder of phase 23: early emission still exercised
VOC_SMALL = {"n_flows": 5, "n_early_every": 2, "n_early_size": 8,
             "n_group": 32, "wn_layers": 2, "wn_channels": 32,
             "log_s_clamp": 2.0, "compute_dtype": "float32"}
# the audio phase, card vs CPU: f32 FFTs (cuFFT vs pocketfft) and matmuls
# in other summation orders, through 32 Griffin-Lim iterations, relative
# to the largest sample
AUDIO_TOL = 1e-3
VOC_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_vocoder"


def vocoder_config(**overrides) -> Config:
    """base.yaml (vocoder bf16) with ``overrides`` on its vocoder."""
    cfg = base_config()
    return dataclasses.replace(cfg, vocoder=dataclasses.replace(
        cfg.vocoder, **overrides))


def vocoder_batch(voc, batch: int, device, seed: int = SEED_DATA):
    """Random mel and audio x 0.1 of one crop, as bench_vocoder_train."""
    g = torch.Generator().manual_seed(seed)
    seg = voc.audio_segment_length
    return {"mel": torch.randn(batch, seg // voc.hop_length, voc.n_mels,
                               generator=g).to(device),
            "audio": (0.1 * torch.randn(batch, seg, generator=g)).to(device)}


def phase_kernels_vocoder_train():
    """K2 at the train step's shape, bf16 x with f32 w/b and f32: against
    its plain version, twice bit-equal, and the Function's gradients
    against the plain conv's autograd.  Returns the bf16 case's error."""
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, w, b = _dw_case(VOC_SHAPE, 3, dtype, torch.float32)
        got = depthwise_conv1d(x, w, b)
        again = depthwise_conv1d(x, w, b)
        torch.cuda.synchronize()
        want = depthwise_conv1d_reference(x, w, b)
        err, abs_err = _scaled_err(got, want), _abs_err(got, want)
        dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(
            SEED_END)).to("cuda", dtype)
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        depthwise_conv1d(*leaves).backward(dy)
        grad_errs = [_scaled_err(t.grad, g) for t, g in zip(
            leaves, _plain_dw_grads(x, w, b, dy))]
        tol = KERNEL_TOL[dtype]
        print(f"[kernels-vocoder-train] K2 {VOC_SHAPE} K3 x {str(dtype)[6:]}, "
              f"w/b f32: max err {err:.3e} (abs {abs_err:.3e}), twice "
              f"bit-equal {torch.equal(got, again)}; Function gradients dx "
              f"{grad_errs[0]:.3e}, dw {grad_errs[1]:.3e}, db "
              f"{grad_errs[2]:.3e}; tol {tol:g}")
        _require(err <= tol and max(grad_errs) <= tol
                 and torch.equal(got, again), f"K2 {dtype} at {VOC_SHAPE}")
        main.setdefault("depthwise_train", abs_err)
    return main


def _check_vocoder_step(metrics, grads, names, what, nonzero=False):
    _require(all(bool(torch.isfinite(v)) for v in metrics.values()),
             f"{what}: non-finite metrics {metrics}")
    for name, g in zip(names, grads):
        _require(bool(torch.isfinite(g).all()),
                 f"{what}: non-finite gradient of {name}")
        _require(not nonzero or bool((g != 0).any()),
                 f"{what}: zero gradient of {name}")


def _write_clip(path, n_frames: int, voc, g) -> None:
    """A random clip in the .rclip layout ``rtts_torch.data.read_clip``
    reads: magic, version 1, n_tokens, n_frames, n_mels, n_samples, then
    int32 tokens, f32 mel frames and f32 samples."""
    tokens = torch.randint(3, 40, (12,), generator=g, dtype=torch.int32)
    mel = torch.randn(n_frames, voc.n_mels, generator=g)
    audio = 0.1 * torch.randn(n_frames * voc.hop_length, generator=g)
    with open(path, "wb") as f:
        f.write(b"RCLP" + struct.pack("<5I", 1, tokens.numel(), n_frames,
                                      voc.n_mels, audio.numel()))
        for t in (tokens, mel, audio):
            f.write(t.numpy().tobytes())


def _vocoder_corpus(root: pathlib.Path, voc, n_clips: int = 6) -> None:
    """``n_clips`` random clips, each longer than one crop, and the
    ``manifest.json`` that ``rtts_torch.data.Manifest.load`` reads."""
    root.mkdir(parents=True, exist_ok=True)
    g = torch.Generator().manual_seed(SEED_DATA)
    crop = voc.audio_segment_length // voc.hop_length
    clips = []
    for i in range(n_clips):
        n_frames = crop + 8 * (i + 1)
        path = root / f"clip{i}.rclip"
        _write_clip(path, n_frames, voc, g)
        clips.append({"clip": str(path), "n_frames": n_frames,
                      "n_samples": n_frames * voc.hop_length,
                      "n_tokens": 12})
    (root / "manifest.json").write_text(json.dumps({
        "sample_rate": voc.sample_rate, "hop_length": voc.hop_length,
        "n_mels": voc.n_mels, "clips": clips}))


def _trainer_vocoder_config(data_dir: pathlib.Path) -> Config:
    """base.yaml's vocoder and optimizer with a short run's cadence: eval
    every 2 steps over one batch, a checkpoint every 2, every step logged."""
    cfg = base_config()
    exp = cfg.experiment
    return dataclasses.replace(
        cfg,
        dataset=dataclasses.replace(cfg.dataset, data_dir=str(data_dir),
                                    val_fraction=0.2),
        experiment=dataclasses.replace(
            exp, eval_batches=1,
            logging=dataclasses.replace(exp.logging, log_every_steps=1,
                                        eval_every_steps=2),
            checkpoint=dataclasses.replace(exp.checkpoint,
                                           save_every_steps=2, keep=2)))


def _train_vocoder_resume(device) -> dict:
    """``train_vocoder`` on a corpus written here: 4 steps (eval at 2 and
    4), a resume to 6, and 6 steps in one run.  Returns the runs' metrics
    and the first run's val lines, wav artifacts and checkpoints."""
    shutil.rmtree(VOC_DIR, ignore_errors=True)
    _vocoder_corpus(VOC_DIR / "data", base_config().vocoder)
    cfg = _trainer_vocoder_config(VOC_DIR / "data")
    work = VOC_DIR / "a"
    first = train_vocoder(cfg, str(work), max_steps=4, device=device)
    vals = [json.loads(line) for line in open(work / "metrics.jsonl")
            if "val/loss_vocoder" in line]
    artifacts = sorted(p.name for p in (work / "artifacts").glob("*.wav"))
    checkpoints = sorted(p.name for p in (work / "checkpoints").glob("step_*"))
    resumed = train_vocoder(cfg, str(work), max_steps=6, device=device)
    whole = train_vocoder(cfg, str(VOC_DIR / "b"), max_steps=6,
                          device=device)
    return {"first": first, "resumed": resumed, "whole": whole, "vals": vals,
            "artifacts": artifacts, "checkpoints": checkpoints}


def phase_train_vocoder():
    """Three base.yaml vocoder train steps at full width (b8 x 16384
    samples, bf16), 96 K2 launches each, gradients finite and, at step 3,
    nonzero everywhere; one eval step and one ``infer``, 96 launches each;
    one step at flagship.yaml's vocoder settings; then ``train_vocoder``
    with an eval, a checkpoint and a resume.  Returns the model and the
    three steps' K2 launches."""
    cfg = vocoder_config()
    voc = cfg.vocoder
    per_step = voc.n_flows * voc.wn_layers
    model = SW.init(voc, torch.Generator().manual_seed(SEED_VOC), "cuda")
    names = [n for n, _ in model.named_parameters()]
    optimizer = make_optimizer(cfg.experiment.optim)
    state = optimizer.init(list(model.parameters()))
    step_fn = make_vocoder_train_step(voc, optimizer)
    batch = vocoder_batch(voc, VOC_BATCH, "cuda")
    depthwise_conv1d.launches = 0
    t0 = time.perf_counter()
    steps = [step_fn(model, state, batch, return_grads=True)
             for _ in range(3)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = depthwise_conv1d.launches
    for i, (metrics, grads) in enumerate(steps):
        _check_vocoder_step(metrics, grads, names, f"vocoder step {i + 1}",
                            nonzero=i == 2)
        print(f"[train-vocoder] step {i + 1}: loss "
              f"{float(metrics['loss_vocoder']):.6f}, z_rms "
              f"{float(metrics['z_rms']):.4f}, log_det_mean "
              f"{float(metrics['log_det_mean']):.3e}, grad_norm "
              f"{float(metrics['grad_norm']):.6f}; zero gradients "
              f"{sum(not bool((g != 0).any()) for g in grads)} of "
              f"{len(grads)}")
    print(f"[train-vocoder] base.yaml vocoder b{VOC_BATCH} x "
          f"{voc.audio_segment_length} samples bf16: 3 steps in {dt:.2f} s "
          f"(the first one cold); K2 launches {launches}")
    _require(launches == 3 * per_step,
             f"expected {per_step} K2 launches per step, got {launches} "
             "over 3 steps")

    depthwise_conv1d.launches = 0
    metrics = make_vocoder_eval_step(voc)(model, batch)
    eval_launches = depthwise_conv1d.launches
    depthwise_conv1d.launches = 0
    audio = SW.infer(model, voc, batch["mel"],
                     generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    infer_launches = depthwise_conv1d.launches
    print(f"[train-vocoder] eval step: loss "
          f"{float(metrics['loss_vocoder']):.6f}, K2 launches "
          f"{eval_launches}; infer on the batch's mel -> {tuple(audio.shape)}"
          f", K2 launches {infer_launches}")
    _require(all(bool(torch.isfinite(v)) for v in metrics.values())
             and eval_launches == per_step and infer_launches == per_step
             and audio.shape == batch["audio"].shape
             and bool(torch.isfinite(audio).all()), "vocoder eval / infer")

    flag = dataclasses.replace(voc, **FLAGSHIP_VOCODER)
    flag_model = SW.init(flag, torch.Generator().manual_seed(SEED_VOC),
                         "cuda")
    flag_opt = make_optimizer(cfg.experiment.optim)
    flag_state = flag_opt.init(list(flag_model.parameters()))
    depthwise_conv1d.launches = 0
    metrics, grads = make_vocoder_train_step(flag, flag_opt)(
        flag_model, flag_state, batch, return_grads=True)
    torch.cuda.synchronize()
    flag_launches = depthwise_conv1d.launches
    _check_vocoder_step(metrics, grads, names, "flagship vocoder step")
    print(f"[train-vocoder] flagship.yaml vocoder (f32, log_s_clamp 5.0): "
          f"loss {float(metrics['loss_vocoder']):.6f}, grad_norm "
          f"{float(metrics['grad_norm']):.6f}; K2 launches {flag_launches}")
    _require(flag_launches == per_step, "flagship step K2 launches")
    del flag_model, flag_state

    t0 = time.perf_counter()
    try:
        run = _train_vocoder_resume("cuda")
    finally:
        shutil.rmtree(VOC_DIR, ignore_errors=True)
    vals = run["vals"]
    print(f"[train-vocoder] train_vocoder: 4 steps, evals at "
          f"{[v['step'] for v in vals]}: "
          + "; ".join(f"val/loss_vocoder {v['val/loss_vocoder']:.6f} "
                      f"val/mr_stft {v.get('val/mr_stft', float('nan')):.4f}"
                      for v in vals)
          + f"; artifacts {run['artifacts']}, checkpoints "
          f"{run['checkpoints']}; resumed to 6: loss "
          f"{run['resumed']['loss_vocoder']!r} vs 6 in one run "
          f"{run['whole']['loss_vocoder']!r} ({time.perf_counter() - t0:.1f}"
          f" s)")
    same = {k: run["resumed"][k] == run["whole"][k]
            for k in run["whole"] if k != "steps_per_sec"}
    _require([v["step"] for v in vals] == [2, 4]
             and all(np.isfinite(v["val/mr_stft"]) for v in vals)
             and run["artifacts"] == ["vocoder_step2.wav",
                                      "vocoder_step4.wav"]
             and "step_4" in run["checkpoints"]
             and np.isfinite(run["first"]["loss_vocoder"]),
             f"train_vocoder's evals, artifacts or checkpoints: {vals}, "
             f"{run['artifacts']}, {run['checkpoints']}")
    _require(all(same.values()), f"the resumed run's metrics differ from "
             f"one run's: {same}")
    return model, {"depthwise_train": launches}


def _vocoder_f32_step(voc, optim, batch, device):
    model = SW.init(voc, torch.Generator().manual_seed(SEED_VOC), "cpu")
    g = torch.Generator().manual_seed(SEED_END)
    with torch.no_grad():   # live "end" convs: the WN stacks reach z
        for flow in model.flows:
            for p in (flow.wn.end.w, flow.wn.end.b):
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    model = model.to(device)
    optimizer = make_optimizer(optim)
    state = optimizer.init(list(model.parameters()))
    metrics, grads = make_vocoder_train_step(voc, optimizer)(
        model, state, {k: v.to(device) for k, v in batch.items()},
        return_grads=True)
    return ({k: float(v) for k, v in metrics.items()},
            [g.cpu() for g in grads],
            [p.detach().cpu() for p in model.parameters()],
            [n for n, _ in model.named_parameters()])


def phase_train_vocoder_card_vs_cpu():
    """One f32 vocoder step at reduced depth (``VOC_SMALL``), "end" live,
    constant lr: the card (K2) against the CPU (its plain version in the
    same autograd.Function), from the same weights and batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = vocoder_config(**VOC_SMALL, audio_segment_length=4096)
    optim = dataclasses.replace(cfg.experiment.optim, schedule="constant")
    lr = optim.learning_rate
    batch = vocoder_batch(cfg.vocoder, 4, "cpu")
    cpu = _vocoder_f32_step(cfg.vocoder, optim, batch, "cpu")
    depthwise_conv1d.launches = 0
    card = _vocoder_f32_step(cfg.vocoder, optim, batch, "cuda")
    launches = depthwise_conv1d.launches
    errs = {k: abs(card[0][k] - cpu[0][k]) / max(1.0, abs(cpu[0][k]))
            for k in cpu[0]}
    grad_errs = {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)
                     ).item() for n, a, b in zip(cpu[3], card[1], cpu[1])}
    worst = max(grad_errs, key=grad_errs.get)
    param_err = max((a - b).abs().max().item()
                    for a, b in zip(card[2], cpu[2]))
    n_dw = cfg.vocoder.n_flows * cfg.vocoder.wn_layers
    print(f"[train-vocoder-card-vs-cpu] f32 {VOC_SMALL} b4 x 4096 samples: "
          f"loss {card[0]['loss_vocoder']:.6f} vs {cpu[0]['loss_vocoder']:.6f}"
          f", worst metric err {max(errs.values()):.3e}, worst gradient leaf "
          f"{worst} {grad_errs[worst]:.3e} (relative to its largest entry), "
          f"params after the update {param_err:.3e} (lr {lr:g}); tol "
          f"{TRAIN_SLICE_TOL:g}, params {TRAIN_PARAM_TOL_LR:g} lr; card K2 "
          f"launches {launches}")
    _require(launches == n_dw, f"the card's step launched K2 {launches} "
             f"times, not {n_dw}")
    _require(max(errs.values()) <= TRAIN_SLICE_TOL
             and grad_errs[worst] <= TRAIN_SLICE_TOL
             and all(bool(g.abs().max() > 0) for g in cpu[1])
             and param_err <= TRAIN_PARAM_TOL_LR * lr,
             "card and CPU vocoder steps disagree")


def _sync_warnings(fn) -> int:
    """How many host synchronizations ``fn`` makes, by CUDA's sync debug
    mode (a warning "called a synchronizing CUDA operation" each; the
    mode's own notice that it is a prototype does not count)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


def _dw_backward_ms(shape, n=200) -> dict:
    """K2's Function at ``shape`` (bf16 x, f32 w/b): forward alone and
    forward + backward (the plain f32 conv's autograd) by the events loop;
    the backward is their difference; and the device time of forward +
    backward by the profiler."""
    x, w, b = _dw_case(shape, 3, torch.bfloat16, torch.float32)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        SEED_END)).to("cuda", x.dtype)
    leaves = [t.detach().requires_grad_() for t in (x, w, b)]
    fwd = lambda: depthwise_conv1d(*leaves)  # noqa: E731
    both = lambda: torch.autograd.grad(depthwise_conv1d(*leaves), leaves,  # noqa: E731
                                       dy)
    fwd_ms, both_ms = _interleaved_ms((fwd, both), n)
    return {"fwd": fwd_ms, "fwd_bwd": both_ms, "bwd": both_ms - fwd_ms,
            "fwd_bwd_device": _device_ms(both, n)}


def phase_train_vocoder_timing(model):
    """The bf16 vocoder train step at b8 x 16384 samples: best of 3 after a
    warm-up, peak device memory, host synchronizations, a profile of one
    step (with slogdet's share), slogdet alone; K2 at (8, 128, 128)
    against its plain version, F.conv1d and its bound, and the Function's
    backward."""
    cfg = vocoder_config()
    voc = cfg.vocoder
    optimizer = make_optimizer(cfg.experiment.optim)
    state = optimizer.init(list(model.parameters()))
    step_fn = make_vocoder_train_step(voc, optimizer)
    batch = vocoder_batch(voc, VOC_BATCH, "cuda")

    def step():
        metrics = step_fn(model, state, batch)
        torch.cuda.synchronize()
        return metrics

    step()   # warm-up
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        metrics = step()
        walls.append(time.perf_counter() - t0)
        _require(bool(torch.isfinite(metrics["loss_vocoder"])),
                 "timed vocoder step loss")
    peak = torch.cuda.max_memory_allocated() / 2**30
    best = min(walls)
    audio_s = VOC_BATCH * voc.audio_segment_length / voc.sample_rate
    syncs = _sync_warnings(lambda: step_fn(model, state, batch))
    control = _sync_warnings(lambda: batch["audio"][0, 0].item())
    _require(control >= 1, "CUDA's sync debug mode reported no "
             "synchronization in .item()")
    print(f"[train-vocoder-timing] vocoder train step b{VOC_BATCH} x "
          f"{voc.audio_segment_length} samples (base.yaml, bf16): walls "
          f"{[round(w, 4) for w in walls]} s; best {best:.4f} s = "
          f"{audio_s / best:.1f} audio s/s (train RTF {best / audio_s:.5f}); "
          f"peak memory {peak:.3f} GiB; host synchronizations in one step "
          f"{syncs} (.item(), the control: {control})")
    wall, events = _profile_events(step)
    busy, n_kernels, ops = _profile_summary(events)
    slog = sum(e.device_time_total for e in events
               if e.key == "aten::linalg_slogdet") / 1e6
    print(f"[train-vocoder-timing] profile of one step: wall {wall:.4f} s, "
          f"device busy {busy:.4f} s, idle {1 - busy / wall:.1%}; "
          f"{n_kernels} device activities; slogdet {slog * 1e3:.4f} ms "
          f"({slog / busy:.2%} of busy); device time by op: {ops}")
    ws = [f.inv1x1.w_1x1.detach().float() for f in model.flows]
    slog_ms = _events_ms(lambda: [torch.linalg.slogdet(w) for w in ws], 50)
    slog_syncs = _sync_warnings(lambda: [torch.linalg.slogdet(w)
                                         for w in ws])
    print(f"[train-vocoder-timing] slogdet of the 12 1x1 weights "
          f"({sorted({w.shape[0] for w in ws})}): {slog_ms:.4f} ms a step "
          f"by events; host synchronizations {slog_syncs}")
    times = _dw_times(VOC_SHAPE)
    bwd = _dw_backward_ms(VOC_SHAPE)
    print(f"[train-vocoder-timing] K2's Function at {VOC_SHAPE}: forward "
          f"{bwd['fwd']:.4f} ms, forward + backward {bwd['fwd_bwd']:.4f} ms "
          f"(device {bwd['fwd_bwd_device']:.4f}), "
          f"backward {bwd['bwd']:.4f} ms (events)")
    return {"depthwise_train": times}


def phase_audio():
    """Griffin-Lim serving on the card (no vocoder), Griffin-Lim and the
    log-mel card against CPU, and the denoiser on a vocoded utterance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = base_config()
    tts = M.init(cfg.model, torch.Generator().manual_seed(SEED_TTS), "cuda")
    syn = Synthesizer(cfg, tts, None, max_frames=256)
    mel, lengths = syn.text_to_mel(SENTENCES[:1])
    t0 = time.perf_counter()
    wav = syn.mel_to_audio(mel[0], int(lengths[0]))
    dt = time.perf_counter() - t0
    hop = cfg.dataset.audio.hop_length
    print(f"[audio] Synthesizer without a vocoder: {int(lengths[0])} frames "
          f"-> {wav.shape[0]} samples by Griffin-Lim (32 iterations) on the "
          f"card in {dt:.3f} s")
    _require(wav.shape == (int(lengths[0]) * hop,)
             and bool(np.isfinite(wav).all()), "Griffin-Lim serving")
    del syn, tts

    g = torch.Generator().manual_seed(SEED_DATA)
    mag = torch.randn(128, 513, generator=g).abs()
    angle = (2 * torch.rand(mag.shape, generator=g) - 1) * np.pi
    gl = [_griffin_lim_from_angle(mag.to(d), angle.to(d), 1024, 256, 32)
          for d in ("cpu", "cuda")]
    gl_err = _rel_err(gl[1], gl[0])
    x = 0.1 * torch.randn(2, 16384, generator=g)
    audio_cfg = cfg.dataset.audio
    cpu_mel = log_mel_spectrogram(x, audio_cfg)
    card = {m: log_mel_spectrogram(x.cuda(), audio_cfg, method=m)
            for m in ("matmul", "fft")}
    mel_errs = (_rel_err(card["matmul"], card["fft"]),
                _rel_err(card["matmul"], cpu_mel))
    print(f"[audio] Griffin-Lim 128 frames x 32 iterations, one angle: card "
          f"vs CPU err {gl_err:.3e} (tol {AUDIO_TOL:g}); log-mel b2 x 16384 "
          f"on the card, matmul vs fft {mel_errs[0]:.3e}, vs the CPU "
          f"{mel_errs[1]:.3e} (tol {AUDIO_TOL:g})")
    _require(gl_err <= AUDIO_TOL and max(mel_errs) <= AUDIO_TOL,
             "Griffin-Lim or the log-mel: card and CPU disagree")

    _, voc = build_models(cfg, "cuda")
    utt = SW.infer(voc, cfg.vocoder, card["matmul"][:1],
                   generator=torch.Generator(device="cuda").manual_seed(0))[0]
    den = Denoiser(voc, cfg.vocoder, strength=0.1)
    out = den(utt.cpu().numpy())
    want = denoise(utt.cpu(), den.bias.cpu(), 0.1)
    den_err = _rel_err(torch.from_numpy(out), want)
    print(f"[audio] denoiser on a vocoded utterance of {utt.shape[0]} "
          f"samples: bias spectrum {tuple(den.bias.shape)} on "
          f"{den.bias.device}, card vs CPU denoise err {den_err:.3e} (tol "
          f"{AUDIO_TOL:g})")
    _require(den.bias.is_cuda and out.shape == (utt.shape[0],)
             and bool(np.isfinite(out).all()) and den_err <= AUDIO_TOL,
             "the denoiser")


# -- serving in every decode cache (phases 26-29) -------------------------------

# configs/parity_local.yaml as a dict (tests/test_torch_guards.py holds the
# two equal)
_PARITY_LOCAL_ATTENTION = {"kind": "lsh", "num_heads": 4, "head_dim": 64,
                           "num_hashes": 2, "chunk_length": 32,
                           "num_chunks_before": 1}
PARITY_LOCAL_CONFIG = {
    "dataset": {"data_dir": "data_flagship", "batch_size": 8,
                "max_mel_len": 512},
    "model": {
        "d_model": 256,
        "n_mels": 80,
        "reduction_factor": 2,
        "guided_attention_weight": 2.0,
        "guided_attention_decay_steps": 1500,
        "encoder": {"num_layers": 4, "d_model": 256, "d_ff": 1024,
                    "reversible": True, "causal": False,
                    "attention": dict(_PARITY_LOCAL_ATTENTION)},
        "decoder": {"num_layers": 4, "d_model": 256, "d_ff": 1024,
                    "reversible": False, "causal": True,
                    "attn_layers": ["local", "lsh", "local", "lsh"],
                    "attention": dict(_PARITY_LOCAL_ATTENTION)},
        "compute_dtype": "bfloat16",
    },
    "experiment": {"max_steps": 2000,
                   "optim": {"learning_rate": 3.0e-4, "warmup_steps": 200,
                             "schedule": "noam"},
                   "checkpoint": {"save_every_steps": 500},
                   "logging": {"eval_every_steps": 500}},
}
# parity_local's ragged train batch (its max_mel_len is 512)
# (192 tokens: the encoder's LSH chunks, 12 a row, differ in shape from
# the local layers' 8)
LOCAL_TOKEN_LENS = (192, 150, 99, 58, 192, 9, 48, 187)
LOCAL_FRAME_LENS = (512, 400, 262, 154, 500, 20, 128, 512)
# the local layers' chunk attend in a parity_local train step: b8 h4, 256
# groups in chunks of 32, causal, one chunk back, the ragged groups valid
LOCAL_CASE = (8, 4, 1, 256, 32, True, 1, 0,
              tuple(-(-n // 2) for n in LOCAL_FRAME_LENS))
_DECODE_KERNELS = (flash_attend, lsh_attend_fwd, sort_by_bucket,
                   depthwise_conv1d)
# the kv_lsh_chunk / kv_full crossover: per-step time at these groups
CROSSOVER_STEPS = (1024, 4096, 8191)


def serving_config(base, **model_overrides) -> Config:
    """A shipped config as served: the vocabulary size set, bf16, and
    ``model_overrides``."""
    data = copy.deepcopy(base)
    data["model"].update(vocab_size=frontend_vocab_size("char"),
                         **model_overrides)
    data.setdefault("vocoder", {})["compute_dtype"] = "bfloat16"
    return from_dict(Config, data)


def _decode_counts():
    return {"flash": flash_attend.launches, "lsh_attend": lsh_attend_fwd.launches,
            "sort_by_bucket": sort_by_bucket.launches,
            "depthwise": depthwise_conv1d.launches}


def _reset_decode_counts():
    for fn in _DECODE_KERNELS:
        fn.launches = 0


def _timed_decode(tts, model_cfg, memory, mask, frames, **kw):
    """One greedy decode to ``frames`` frames at stop threshold 2.0 (no row
    stops) -> (wall s by the host clock, the result)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = decode_greedy(tts, model_cfg, memory, mask, max_frames=frames,
                        generator=gen, stop_threshold=2.0, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b = memory.shape[0]
    _require(tuple(res.mel_post.shape) == (b, frames, model_cfg.n_mels)
             and bool(torch.isfinite(res.mel_post).all())
             and bool((res.lengths == frames).all()),
             f"decode to {frames} frames: shape "
             f"{tuple(res.mel_post.shape)}, lengths {res.lengths.tolist()}")
    return wall, res


def _check_wavs(wavs, lengths, hop, n):
    _require(len(wavs) == n, "wrong number of waveforms")
    for w, frames in zip(wavs, lengths):
        _require(w.shape == (int(frames) * hop,)
                 and bool(np.isfinite(w).all()),
                 f"waveform {w.shape} for {frames} frames")


def _filled_decoder(tts, model_cfg, memory, mask, frames, mode, t,
                    window=None):
    """A decoder (``decode_greedy``'s state and step) at step ``t`` of a
    ``frames`` decode in ``mode`` (with the cross-attention ``window``),
    its caches filled from a seed: random keys and values, every
    kv_lsh_chunk ring full of positions below t."""
    n_groups = frames // model_cfg.reduction_factor
    rotations, nb = None, 0
    if mode in ("kv_lsh", "kv_lsh_chunk"):
        rotations, nb = TD._decode_rotations(model_cfg, None, frames, "cuda")
    local_spec = (TD._local_spec(model_cfg, n_groups) if mode == "kv_local"
                  else None)
    dec = TD._Decoder(tts, model_cfg, memory, mask, n_groups, n_groups, mode,
                      torch.Generator(device="cuda").manual_seed(0), 2.0,
                      rotations, nb, local_spec, window)
    g = torch.Generator(device="cuda").manual_seed(SEED_DATA)
    for cache in dec.k_caches + dec.v_caches:
        cache.copy_(TD._to_kv(torch.randn(cache.shape, generator=g,
                                          device="cuda"), cache.dtype))
    for ring in dec.b_caches:
        if isinstance(ring, tuple):
            idx, cnt = ring
            idx.copy_(torch.randint(0, t, idx.shape, generator=g,
                                    device="cuda"))
            cnt.fill_(idx.shape[-1])
    dec.prev = torch.randn(dec.prev.shape, generator=g, device="cuda")
    return dec


def _step_ms(dec, t: int, n: int = 20) -> float:
    """Host wall per decode step at group t (the step rewrites position t),
    after two warm-up steps."""
    for _ in range(2):
        dec.step(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        dec.step(t)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def phase_serving_longform():
    """configs/longform_8k.yaml served as ``rtts/bench.py::bench_longform``
    shapes it: b2 x 1024 random tokens, 8192 frames, mode "auto" (which
    must resolve kv_lsh_chunk), stop threshold 2.0; the encoder's K4 and
    K7 launches; decode frames/s; the device's idle share over 64 steps at
    group 4096; and the per-step time of kv_lsh_chunk against kv_full at
    groups 1024, 4096 and 8191 with caches filled from a seed, in turns
    (chunk, full, full, chunk)."""
    cfg = serving_config(LONGFORM_CONFIG)
    mcfg = cfg.model
    tts = TD._precast_weights(
        M.init(mcfg, torch.Generator().manual_seed(SEED_TTS), "cuda"),
        torch.bfloat16)
    b, n_tok, frames = 2, 1024, 8192
    mode = TD._auto_mode(mcfg, frames)
    _require(mode == "kv_lsh_chunk", f"auto resolved {mode}, not kv_lsh_chunk")
    tokens, mask = _bench_inputs(cfg, b, n_tok)
    _reset_decode_counts()
    with torch.no_grad():
        memory = M.encode(tts, mcfg, tokens, mask)
    enc = _decode_counts()
    n_enc = mcfg.encoder.num_layers
    _require(enc["lsh_attend"] == n_enc and enc["sort_by_bucket"] == n_enc,
             f"the LSH encoder launched {enc}, not {n_enc} K4 and K7")
    wall, res = _timed_decode(tts, mcfg, memory, mask, frames, mode="auto")
    print(f"[serving-longform] longform_8k.yaml b{b} x {n_tok} tokens x "
          f"{frames} frames (bf16, auto -> {mode}, stop 2.0): encoder "
          f"launches K4 {enc['lsh_attend']}, K7 {enc['sort_by_bucket']}; "
          f"decode wall {wall:.3f} s = {b * frames / wall:.1f} frames/s, "
          f"{wall / (frames // mcfg.reduction_factor) * 1e3:.3f} ms a step")
    del res
    dec = _filled_decoder(tts, mcfg, memory, mask, frames, mode, 4096)
    dec.step(4096)

    def window():
        for _ in range(64):
            dec.step(4096)
        torch.cuda.synchronize()

    pwall, busy, n_kernels, ops = _profile(window)
    print(f"[serving-longform] profile of 64 kv_lsh_chunk steps at group "
          f"4096: wall {pwall:.4f} s, device busy {busy:.4f} s, idle "
          f"{1 - busy / pwall:.1%}; {n_kernels / 64:.1f} device activities "
          f"a step; device time by op: {ops}")
    del dec
    step_ms = {}
    for t in CROSSOVER_STEPS:
        decs = {m: _filled_decoder(tts, mcfg, memory, mask, frames, m, t)
                for m in ("kv_lsh_chunk", "kv_full")}
        runs = {m: [] for m in decs}
        for m in ("kv_lsh_chunk", "kv_full", "kv_full", "kv_lsh_chunk"):
            runs[m].append(_step_ms(decs[m], t))
        for m, ms in runs.items():
            step_ms[(m, t)] = sum(ms) / len(ms)
        del decs
    print("[serving-longform] per-step ms (host wall, mean of two turns of "
          "20 steps), kv_lsh_chunk vs kv_full (b2, caches filled): "
          + "; ".join(
              f"group {t}: {step_ms[('kv_lsh_chunk', t)]:.3f} vs "
              f"{step_ms[('kv_full', t)]:.3f} (ratio "
              f"{step_ms[('kv_full', t)] / step_ms[('kv_lsh_chunk', t)]:.3f})"
              for t in CROSSOVER_STEPS))
    torch.cuda.empty_cache()


def phase_serving_fast():
    """configs/serving_fast.yaml as shipped (kv_full, e4m3 caches, staged
    "auto" on at 1024 groups): the Synthesizer answers 8 sentences, with
    the encoder's K4/K7 and the vocoder's K2 launches; then b8 x 256
    tokens x 1024 frames (stop 2.0) with the e4m3 and the compute-dtype
    cache, each staged and not, in turns (A B C D D C B A): decode
    frames/s, and the relative mel L1 of e4m3 against compute."""
    cfg = serving_config(SERVING_FAST_CONFIG)
    mcfg = cfg.model
    _require(TD._auto_mode(mcfg, 1024) == "kv_full"
             and TD._auto_staged(1024)
             and TD._kv_dtype(mcfg, torch.bfloat16) == torch.float8_e4m3fn,
             "serving_fast does not resolve kv_full, staged, e4m3")
    tts, voc = build_models(cfg, "cuda")
    syn = Synthesizer(cfg, tts, voc, max_frames=1024)
    _reset_decode_counts()
    t0 = time.perf_counter()
    wavs = syn(SENTENCES)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _decode_counts()
    _, lengths = syn.text_to_mel(SENTENCES)
    _check_wavs(wavs, lengths, cfg.vocoder.hop_length, len(SENTENCES))
    n_enc = mcfg.encoder.num_layers
    _require(counts["lsh_attend"] >= n_enc
             and counts["sort_by_bucket"] >= n_enc
             and counts["depthwise"] >= cfg.vocoder.n_flows
             * cfg.vocoder.wn_layers * len(SENTENCES),
             f"serving_fast launched {counts}")
    print(f"[serving-fast] Synthesizer, serving_fast.yaml as shipped (kv_full"
          f", e4m3, staged): {len(wavs)} sentences -> frames "
          f"{lengths.tolist()} in {dt:.2f} s; launches {counts}")
    tokens, mask = _bench_inputs(cfg, 8, 256)
    with torch.no_grad():
        memory = M.encode(syn.tts, mcfg, tokens, mask)
    frames = 1024
    variants = [(kv, staged) for kv in ("float8_e4m3fn", "compute")
                for staged in (True, False)]
    walls = {v: [] for v in variants}
    mels = {}
    for v in variants + variants[::-1]:
        kv_cfg = dataclasses.replace(mcfg, kv_cache_dtype=v[0])
        wall, res = _timed_decode(syn.tts, kv_cfg, memory, mask, frames,
                                  staged=v[1])
        walls[v].append(wall)
        mels[v] = res.mel_post
    for v in variants:
        best = min(walls[v])
        print(f"[serving-fast] kv_full b8 x {frames} frames, cache {v[0]}, "
              f"staged {v[1]}: walls {[round(w, 3) for w in walls[v]]} s; "
              f"best {8 * frames / best:.1f} frames/s")
    ref = mels[("compute", True)]
    l1 = ((mels[("float8_e4m3fn", True)] - ref).abs().mean()
          / ref.abs().mean()).item()
    staged_diff = max(_scaled_err(mels[(kv, True)], mels[(kv, False)])
                      for kv in ("float8_e4m3fn", "compute"))
    print(f"[serving-fast] relative mel L1, e4m3 vs compute cache: {l1:.4e}; "
          f"staged vs not, max scaled difference {staged_diff:.3e}")
    _require(all(bool(torch.isfinite(m).all()) for m in mels.values()),
             "non-finite serving_fast mel")
    del syn, tts, voc, mels
    torch.cuda.empty_cache()


def _local_attend_check(dtype):
    """K4/K5 (the kernels' Function) in ``dtype`` against the plain attend
    in f32 on the same values, at the parity_local local layers' inputs:
    out, lse and the gradients of q, k and v."""
    (q, k, v, dout), _, valid, dlse, opts = _lsh_case(*LOCAL_CASE, dtype)
    b, h, nc, c = valid.shape
    pos = torch.arange(nc * c, device="cuda").reshape(1, 1, nc, c).expand(
        b, h, nc, c)
    lens = torch.tensor(LOCAL_CASE[-1], device="cuda")
    valid = pos < lens[:, None, None, None]
    res = {}
    for name, attend, cast in (("kernel", lsh_attend_chunks_kernel, dtype),
                               ("plain", TL.plain_attend, torch.float32)):
        leaves = [t.detach().to(cast).requires_grad_() for t in (q, k, v)]
        out, lse = attend(*leaves, pos, valid, *opts)
        grads = torch.autograd.grad((out, lse), leaves, (dout, dlse))
        res[name] = (out, lse, *grads)
    errs = {key: _scaled_err(a, b_) for key, a, b_ in zip(
        ("out", "lse", "dq", "dk", "dv"), res["kernel"], res["plain"])}
    return errs, (q, k, v, dout, pos, valid, dlse, opts)


def phase_parity_local():
    """configs/parity_local.yaml: K4/K5 on the local layers against the
    plain attend at their train shape (b8 h4, 256 groups, chunk 32, causal,
    one chunk back), forward and backward, bf16 and f32; the Synthesizer
    answers 8 sentences in kv_local ("auto"); b8 x 256 tokens x 512 frames
    in kv_local and kv_full (frames/s); three bf16 train steps at full
    width (b8, ragged up to 128 tokens and 512 frames) with K4/K5 launches
    by shape, the local layers' among them; one f32 step at 2 + 2 layers
    ([local, lsh]) card vs CPU.  Returns the local kernels' launches over
    the three steps and their times."""
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        e, case = _local_attend_check(dtype)
        tol = KERNEL_TOL[dtype]
        print(f"[parity-local] K4/K5 vs the plain attend at the local layers' "
              f"shape {tuple(case[0].shape)} {str(dtype)[6:]}: "
              + ", ".join(f"{key} {v:.3e}" for key, v in e.items())
              + f"; tol {tol:g}")
        _require(all(v <= tol for v in e.values()),
                 "K4/K5 disagree with the plain attend on the local layers")
        errs.setdefault(dtype, e)
    cfg = serving_config(PARITY_LOCAL_CONFIG)
    mcfg = cfg.model
    _require(TD._auto_mode(mcfg, 512) == "kv_local",
             "parity_local does not resolve kv_local")
    tts, voc = build_models(cfg, "cuda")
    syn = Synthesizer(cfg, tts, voc, max_frames=512)
    _reset_decode_counts()
    wavs = syn(SENTENCES)
    counts = _decode_counts()
    _, lengths = syn.text_to_mel(SENTENCES)
    _check_wavs(wavs, lengths, cfg.vocoder.hop_length, len(SENTENCES))
    _require(counts["lsh_attend"] >= mcfg.encoder.num_layers,
             f"parity_local serving launched {counts}")
    tokens, mask = _bench_inputs(cfg, 8, 256)
    with torch.no_grad():
        memory = M.encode(syn.tts, mcfg, tokens, mask)
    walls = {m: [] for m in ("kv_local", "kv_full")}
    for m in ("kv_local", "kv_full", "kv_full", "kv_local"):
        walls[m].append(_timed_decode(syn.tts, mcfg, memory, mask, 512,
                                      mode=m)[0])
    print(f"[parity-local] Synthesizer (auto -> kv_local): frames "
          f"{lengths.tolist()}; launches {counts}; decode b8 x 512 frames "
          "(256 groups, bf16, stop 2.0): " + "; ".join(
              f"{m} walls {[round(w, 3) for w in ws]} s, best "
              f"{8 * 512 / min(ws):.1f} frames/s" for m, ws in walls.items()))
    del syn, tts, voc
    torch.cuda.empty_cache()

    tcfg = train_config(base=PARITY_LOCAL_CONFIG)
    model, state, step_fn = _trainer(tcfg, "cuda")
    names = [n for n, _ in model.named_parameters()]
    batch = train_batch(tcfg, LOCAL_TOKEN_LENS, LOCAL_FRAME_LENS, "cuda")
    for fn in _LSH_KERNELS:
        fn.launches = 0
    with _shape_tally(LA, "lsh_attend_fwd") as k4_shapes, \
            _shape_tally(LA, "lsh_attend_bwd") as k5_shapes:
        for step in range(3):
            metrics, grads = step_fn(model, state, batch,
                                     step_generator(SEED_TRAIN, step, "cuda"),
                                     step, return_grads=True)
            _check_step(tcfg, metrics, grads, names, f"parity_local step "
                        f"{step}")
    torch.cuda.synchronize()
    local_shape = (8, 4, 256 // 32, 32, 64)
    n_local = tcfg.model.decoder.attn_layers.count("local")
    local = {"fwd": k4_shapes.get(local_shape, 0),
             "bwd": k5_shapes.get(local_shape, 0)}
    print(f"[parity-local] three bf16 train steps b8 tokens "
          f"{list(LOCAL_TOKEN_LENS)} frames {list(LOCAL_FRAME_LENS)}: loss "
          f"{float(metrics['loss']):.6f}; K4 launches by shape {k4_shapes}, "
          f"K5 {k5_shapes}; the local layers' {local_shape}: K4 "
          f"{local['fwd'] / 3:g} and K5 {local['bwd'] / 3:g} a step")
    _require(local["fwd"] == 3 * n_local and local["bwd"] == 3 * n_local,
             f"the local layers launched K4/K5 {local} times in 3 steps, "
             f"not {3 * n_local}")
    del model, state, grads
    torch.cuda.empty_cache()

    f32 = train_config("float32", num_layers=2, dropout_off=True,
                       base=PARITY_LOCAL_CONFIG, schedule="constant")
    f32 = dataclasses.replace(f32, model=dataclasses.replace(
        f32.model, decoder=dataclasses.replace(
            f32.model.decoder, attn_layers=["local", "lsh"])))
    _lsh_step_card_vs_cpu(f32, ((128, 90), (512, 380)), "parity-local", 3)

    q, k, v, dout, pos, valid, dlse, opts = _local_attend_check(
        torch.bfloat16)[1]
    fwd = _kernel_ms(lambda: lsh_attend_fwd(q, k, v, pos, valid, *opts),
                     lambda: lsh_attend_chunks_reference(q, k, v, pos, valid,
                                                         *opts), 100)
    bwd = _kernel_ms(
        lambda: lsh_attend_bwd(q, k, v, pos, valid, dout, dlse, *opts),
        lambda: lsh_attend_bwd_reference(q, k, v, pos, valid, dout, dlse,
                                         *opts), 100)
    dev = [_device_ms(lambda: lsh_attend_fwd(q, k, v, pos, valid, *opts),
                      100, ("lsh_attend_fwd_mma",)),
           _device_ms(lambda: lsh_attend_bwd(q, k, v, pos, valid, dout, dlse,
                                             *opts),
                      100, ("lsh_bwd_dq", "lsh_bwd_dkv"))]
    bounds = _lsh_bounds(*LOCAL_CASE, torch.bfloat16)
    print(f"[parity-local] the local layers' shape bf16: K4 {fwd[0]:.4f} ms "
          f"(device {dev[0]:.4f}; plain {fwd[1]:.4f}, bound "
          f"{bounds['fwd']['bound_ms']:.4f} {bounds['fwd']['bound_by']}); K5 "
          f"{bwd[0]:.4f} ms (device {dev[1]:.4f}; plain {bwd[1]:.4f}, bound "
          f"{bounds['bwd']['bound_ms']:.4f} {bounds['bwd']['bound_by']})")
    e = errs[torch.bfloat16]
    return ({"lsh_attend_local": local["fwd"],
             "lsh_attend_bwd_local": local["bwd"]},
            {"lsh_attend_local": dict(
                ms=fwd[0], plain_ms=fwd[1], device_ms=dev[0],
                library_ms=None, **bounds["fwd"]),
             "lsh_attend_bwd_local": dict(
                 ms=bwd[0], plain_ms=bwd[1], device_ms=dev[1],
                 library_ms=None, **bounds["bwd"])},
            {"lsh_attend_local": e["out"],
             "lsh_attend_bwd_local": max(e["dq"], e["dk"], e["dv"])})


def phase_decode_syncs():
    """Each new decode path at a small length, on full-width models with
    random weights: three steps under CUDA's sync debug mode "error" (any
    synchronizing call raises), then a whole decode of 64 groups counted
    in mode "warn", which must synchronize exactly once per ``unroll``
    steps (the stop check)."""
    cases = [("longform kv_lsh_chunk", LONGFORM_CONFIG, "kv_lsh_chunk", {}),
             ("longform kv_lsh", LONGFORM_CONFIG, "kv_lsh", {}),
             ("serving_fast kv_full e4m3, staged, unroll 4",
              SERVING_FAST_CONFIG, "kv_full",
              {"staged": True, "stage_min": 16, "unroll": 4}),
             ("parity_local kv_local, attn_window (2, 4)",
              PARITY_LOCAL_CONFIG, "kv_local", {"attn_window": (2, 4)})]
    for name, base, mode, kw in cases:
        cfg = serving_config(base)
        mcfg = cfg.model
        tts = TD._precast_weights(
            M.init(mcfg, torch.Generator().manual_seed(SEED_TTS), "cuda"),
            torch.bfloat16)
        tokens, mask = _bench_inputs(cfg, 2, 128)
        with torch.no_grad():
            memory = M.encode(tts, mcfg, tokens, mask)
        frames = 64 * mcfg.reduction_factor
        dec = _filled_decoder(tts, mcfg, memory, mask, frames, mode, 3,
                              kw.get("attn_window"))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for t in range(3):
                dec.step(t)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = _sync_warnings(lambda: decode_greedy(
            tts, mcfg, memory, mask, max_frames=frames, stop_threshold=2.0,
            mode=mode, **kw))
        checks = 64 // kw.get("unroll", 1)
        print(f"[decode-syncs] {name}: three steps under sync debug mode "
              f"'error' raised nothing; a decode of 64 groups synchronized "
              f"{syncs} times ({checks} stop checks)")
        _require(syncs == checks, f"{name}: {syncs} synchronizations, not "
                 f"{checks}")
        del tts, dec
    torch.cuda.empty_cache()

# -- phase 30: the serving surfaces -------------------------------------------

# rtts/bench.py's serving workloads: bench_continuous's and bench_serving's
# true lengths (pinned by their budgets at stop threshold 2.0), 8 requests
# each, 8 slots, segments of 64 frames; bench_latency's streaming (batch 1,
# 512 frames, three chunk sizes)
SERVE_LENGTHS = (128, 256, 512, 1024)
SERVE_PER_LENGTH, SERVE_SLOTS, SERVE_SEGMENT = 8, 8, 64
FRAMES_PER_TOKEN = 8.0          # Synthesizer.predict_frames' default
STREAM_FRAMES, STREAM_CHUNKS = 512, (32, 64, 128)
# two bf16 serving surfaces on the same requests, mean |a - b| over mean
# |b| of the mel: they compute the same function and differ in summation
# order (ring capacity, admission step, batch), where one bf16 rounding
# flip (2^-8 relative) feeds back through up to 1024 autoregressive steps;
# the e4m3 cache, a larger perturbation (2^-4 relative a K/V entry), moved
# serving_fast's mel by 9.3e-3 (phase 27); half of this is the bound
SERVE_L1_TOL = 2e-2


def _serving_texts(lengths, seed: int):
    """A text per true length: random letters, one token each, so that
    with the EOS ``predict_frames`` budgets the length exactly."""
    g = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(g.choice(letters, int(n / FRAMES_PER_TOKEN) - 1))
            for n in lengths]


def _l1(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().mean() / want.abs().mean()).item()


def _timed_method(obj, name: str, log: dict):
    """Shadow ``obj.name`` with a wrapper that keeps the last call's result
    and host wall in ``log`` (``del obj.name`` restores the method).  The
    methods wrapped end in a read of the device, so the wall needs no
    synchronization of its own."""
    method = getattr(obj, name)

    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        log["out"] = method(*args, **kw)
        log["s"] = time.perf_counter() - t0
        return log["out"]

    setattr(obj, name, wrapped)


def _serve_kernel_times(lens, dw_shape) -> dict:
    """K1 at the admission encode's self-attention and K2 at the batched
    vocode's largest class: the error against the plain version, times and
    bounds, as phases 3 and 5 take them at the Synthesizer's shapes."""
    bf = torch.bfloat16
    b, lk = len(lens), max(lens)
    args, kw = _flash_case(b, 8, lk, lk, bf, lens)
    err = _abs_err(flash_attend(*args, **kw),
                   flash_attend_reference(*args, **kw))
    _require(_scaled_err(flash_attend(*args, **kw),
                         flash_attend_reference(*args, **kw))
             <= KERNEL_TOL[bf], "K1 disagrees at the admission shape")
    fn = lambda: flash_attend(*args, **kw)  # noqa: E731
    k_ms, plain_ms = _kernel_ms(fn, lambda: flash_attend_reference(*args,
                                                                   **kw))
    flash = dict(ms=k_ms, plain_ms=plain_ms, library_ms=None,
                 device_ms=_device_ms(fn, 100, ("flash_fwd",)),
                 max_abs_err=err,
                 **_flash_bounds(b, 8, lk, lk, 64, bf, False, True)["fwd"])
    x, w, bias = _dw_case(dw_shape, 3, bf, torch.float32)
    got, want = depthwise_conv1d(x, w, bias), depthwise_conv1d_reference(
        x, w, bias)
    _require(_scaled_err(got, want) <= KERNEL_TOL[bf],
             "K2 disagrees at the batched vocode's shape")
    dw = dict(_dw_times(dw_shape), max_abs_err=_abs_err(got, want))
    print(f"[serving] K1 at the admission encode b{b} h8 L{lk} bf16: "
          f"{flash['ms']:.4f} ms (device {flash['device_ms']:.4f}), plain "
          f"{flash['plain_ms']:.4f}, bound {flash['bound_ms']:.4f} ms; K2 at "
          f"{dw_shape}: {dw['ms']:.4f} ms (device {dw['device_ms']:.4f})")
    return {"flash_serve": flash, "depthwise_serve": dw}


def _serve_continuous(syn, texts, workload, hop):
    """(a): ``serve_continuous(vocode="batched")`` under sync debug mode
    "warn", with K1/K2 launches and serve_batch's boundaries counted."""
    log = {}
    _timed_method(syn, "serve_continuous_to_mel", log)
    _reset_decode_counts()
    b0 = serve_batch.boundaries
    wavs = []
    t0 = time.perf_counter()
    syncs = _sync_warnings(lambda: wavs.extend(syn.serve_continuous(
        texts, frames_per_token=FRAMES_PER_TOKEN, slots=SERVE_SLOTS,
        segment_frames=SERVE_SEGMENT, vocode="batched", escalate=False)))
    wall = time.perf_counter() - t0
    del syn.serve_continuous_to_mel
    counts = _decode_counts()
    boundaries = serve_batch.boundaries - b0
    rows, lengths = log["out"]
    n_cls = len(SERVE_LENGTHS)
    _require(lengths == list(workload), f"lengths {lengths}")
    _check_wavs(wavs, lengths, hop, len(workload))
    # one a boundary; one read of every class's lengths; one copy of each
    # class's audio
    allowed = boundaries + 1 + n_cls
    _require(syncs <= allowed, f"serve_continuous synchronized {syncs} "
             f"times, more than {allowed}")
    frames = sum(workload)
    print(f"[serving] (a) serve_continuous(vocode='batched'), "
          f"{len(workload)} requests of {SERVE_LENGTHS} frames in arrival "
          f"order, {SERVE_SLOTS} slots, segments of {SERVE_SEGMENT}: wall "
          f"{wall:.3f} s (serve_pool's decode {log['s']:.3f} s = "
          f"{frames / log['s']:.1f} frames/s); {boundaries} boundaries, "
          f"{syncs} host synchronizations (at most {allowed}); launches K1 "
          f"{counts['flash']} K2 {counts['depthwise']}")
    _require(counts["flash"] >= n_cls * 6
             and counts["depthwise"] >= n_cls * 12 * 8,
             f"serve_continuous launched {counts}")
    return rows, counts, frames / log["s"]


def phase_serving():
    """base.yaml at full width (prenet dropout off, so that the surfaces
    compute one function; stop threshold 2.0): (a) serve_continuous, (b)
    ServingEngine, (c) bucketed serve against pad-to-max, (d) streaming,
    (e) serve_batch f32 card vs CPU, (f) streaming vocoding, (g) serve_pool
    at serving_fast.yaml as shipped."""
    cfg = base_config(stop_threshold=2.0, dec_prenet_dropout=0.0)
    mcfg, hop = cfg.model, cfg.vocoder.hop_length
    tts, voc = build_models(cfg, "cuda")
    syn = Synthesizer(cfg, tts, voc, max_frames=max(SERVE_LENGTHS))
    workload = [n for n in SERVE_LENGTHS for _ in range(SERVE_PER_LENGTH)]
    np.random.RandomState(0).shuffle(workload)   # bench_continuous's order
    texts = _serving_texts(workload, SEED_DATA)
    _require(syn.predict_frames(texts) == workload,
             "the texts do not predict their lengths")
    # bench_serving's 4 buckets x 8; pad-to-max timed before (a) and after
    # (c), so that a drift of the host's speed shows
    lens_c = [n for n in SERVE_LENGTHS for _ in range(SERVE_PER_LENGTH)]
    texts_c = _serving_texts(lens_c, SEED_DATA + 1)
    pad_s = [_pad_to_max(syn, texts_c)[2]]
    rows, counts, pool_fps = _serve_continuous(syn, texts, workload, hop)

    # (b) the engine on the same requests in arrival order
    tokens, mask = syn._tokens(texts)
    eng = ServingEngine(cfg, tts, slots=SERVE_SLOTS,
                        capacity_frames=max(SERVE_LENGTHS),
                        segment_frames=SERVE_SEGMENT,
                        token_len=tokens.shape[1],
                        suppress_dispatch_warning=True)
    ids = [eng.submit_tokens(tokens[i:i + 1], mask[i:i + 1], n)
           for i, n in enumerate(workload)]
    done_at = {}

    def drain():
        while not eng.idle:
            for rid in eng.step():
                done_at[rid] = time.perf_counter() - t0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng_syncs = _sync_warnings(drain)
    eng_s = time.perf_counter() - t0
    lat = np.asarray([done_at[i] for i in ids])
    res = [eng.results[i] for i in ids]
    _require([n for _, n in res] == workload, "engine lengths")
    l1 = [_l1(row[:n], rows[i][:n]) for i, (row, n) in enumerate(res)]
    print(f"[serving] (b) ServingEngine, the same {len(ids)} requests: wall "
          f"{eng_s:.3f} s = {sum(workload) / eng_s:.1f} frames/s, {eng.t} "
          f"global steps, completion latency p50 "
          f"{np.percentile(lat, 50):.3f} s p95 {np.percentile(lat, 95):.3f} "
          f"s, {eng_syncs} synchronizations flagged (its harvests wait on "
          f"events); mel L1 against (a): max {max(l1):.3e}, mean "
          f"{np.mean(l1):.3e} (tol {SERVE_L1_TOL:g})")
    _require(max(l1) <= SERVE_L1_TOL, "the engine and serve_pool disagree")
    del eng, res, rows

    # (c) bucketed serve against pad-to-max
    log = {}
    _timed_method(syn, "serve_to_mel", log)
    wavs = syn.serve(texts_c, frames_per_token=FRAMES_PER_TOKEN,
                     escalate=False)
    del syn.serve_to_mel
    mels, lengths = log["out"]
    _require(lengths == lens_c, f"bucketed lengths {lengths}")
    _check_wavs(wavs, lengths, hop, len(texts_c))
    pad_mel, _, wall = _pad_to_max(syn, texts_c)
    pad_s.append(wall)
    # the first n - pn_ctx frames: the postnet's reach of the cut differs
    ctx = mcfg.postnet_layers * (mcfg.postnet_kernel - 1) // 2
    l1 = max(_l1(torch.from_numpy(m[:n - ctx]),
                 torch.from_numpy(pad_mel[i, :n - ctx]))
             for i, (m, n) in enumerate(zip(mels, lengths)))
    frames = sum(lens_c)
    pad_fps = frames / np.mean(pad_s)
    print(f"[serving] (c) bucketed serve, {len(texts_c)} requests in 4 "
          f"buckets: decode {log['s']:.3f} s = {frames / log['s']:.1f} "
          f"useful frames/s; pad-to-max text_to_mel b{len(texts_c)} x "
          f"{max(SERVE_LENGTHS)}: {pad_s[0]:.3f} s before (a), {pad_s[1]:.3f} "
          f"s after (c), {pad_fps:.1f} useful frames/s on their mean; "
          f"against it bucketed {frames / log['s'] / pad_fps:.2f}x, "
          f"serve_pool {pool_fps / pad_fps:.2f}x, the engine "
          f"{sum(workload) / eng_s / pad_fps:.2f}x; mel L1 against "
          f"pad-to-max max {l1:.3e} (tol {SERVE_L1_TOL:g})")
    _require(l1 <= SERVE_L1_TOL, "bucketed serve and pad-to-max disagree")

    # (d) streaming, batch 1
    ss = StreamingSynthesizer(cfg, tts, voc, max_frames=STREAM_FRAMES)
    text = texts_c[-1]
    ref = _decode_frames(tts, mcfg, text, STREAM_FRAMES)
    for chunk in STREAM_CHUNKS:
        out, first = [], []

        def stream():
            for c in ss.stream([text], chunk_frames=chunk):
                if not first:
                    first.append(time.perf_counter() - t0)
                out.append(c)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        syncs = _sync_warnings(stream)
        wall = time.perf_counter() - t0
        audio = np.concatenate(out, axis=1)
        segments = -(-STREAM_FRAMES // chunk)
        print(f"[serving] (d) streaming b1 x {STREAM_FRAMES} frames, chunks "
              f"of {chunk}: time to first audio {first[0]:.3f} s, wall "
              f"{wall:.3f} s, {len(out)} chunks, {syncs} synchronizations "
              f"({segments} segments)")
        _require(audio.shape == (1, STREAM_FRAMES * hop)
                 and bool(np.isfinite(audio).all()), f"audio {audio.shape}")
        _require(syncs <= segments + 1, "streaming synchronized more than "
                 "once a segment and once for the tail")
        _require(torch.equal(ss.last_mel, ref), "streamed frames differ "
                 "from decode_greedy's")

    # (f) mel_to_audio in chunks of 64 against one pass, in f32: the claim
    # is that the windows reproduce one pass (in bf16 the windows' other
    # lengths change cuBLAS's summation order, and twelve flows amplify
    # the flipped roundings)
    mel = mels[lens_c.index(256)]
    cfg32 = base_config("float32")
    syn32 = Synthesizer(cfg32, *build_models(cfg32, "cuda"))
    _reset_decode_counts()
    chunked = syn32.mel_to_audio(mel, streaming_chunk=64)
    n_dw = depthwise_conv1d.launches
    whole = syn32.mel_to_audio(mel)
    err = _scaled_err(torch.from_numpy(chunked), torch.from_numpy(whole))
    print(f"[serving] (f) mel_to_audio f32, {mel.shape[0]} frames in chunks "
          f"of 64 ({n_dw} K2 launches) against one pass: max err {err:.3e}, "
          f"tol {KERNEL_TOL[torch.float32]:g}")
    _require(err <= KERNEL_TOL[torch.float32] and n_dw > 0,
             "streaming vocoding disagrees")
    del syn32
    times = _serve_kernel_times([tokens.shape[1]] * SERVE_SLOTS,
                                (SERVE_SLOTS, max(SERVE_LENGTHS) * hop
                                 // cfg.vocoder.n_group, 128))
    del syn, ss, tts, voc
    torch.cuda.empty_cache()
    _serve_batch_card_vs_cpu()
    _serve_pool_serving_fast()
    return ({"flash_serve": counts["flash"],
             "depthwise_serve": counts["depthwise"]}, times)


def _pad_to_max(syn, texts):
    """``text_to_mel`` of every request at ``max_frames`` -> (mel, lengths,
    wall s); stop 2.0, so every row decodes to the end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mel, lengths = syn.text_to_mel(texts)
    wall = time.perf_counter() - t0
    _require(bool((lengths == syn.max_frames).all()), "pad-to-max lengths")
    return mel, lengths, wall


def _decode_frames(tts, mcfg, text, frames):
    """decode_greedy(kv_full, staged=False)'s frames before the postnet:
    its step loop, with its stop check each step."""
    tokens, mask = encode_batch([text], pad_to_multiple=64)
    tokens = torch.as_tensor(tokens, device="cuda").long()
    mask = torch.as_tensor(mask, device="cuda")
    with torch.no_grad():
        memory = M.encode(tts, mcfg, tokens, mask)
        n = frames // mcfg.reduction_factor
        dec = TD._Decoder(tts, mcfg, memory, mask, n, n, "kv_full",
                          torch.Generator(device="cuda").manual_seed(0),
                          mcfg.stop_threshold)
        for t in range(n):
            dec.step(t)
            if bool(dec.done.all()):
                break
    return dec.mel


def _serve_batch_card_vs_cpu():
    """(e) serve_batch in f32 at 2 + 2 layers, the same weights on the card
    (K1) and on the CPU (its plain version): 4 requests in 2 slots, so two
    are admitted into recycled slots."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_config("float32", num_layers=2, dropout_off=True)
    mcfg = dataclasses.replace(cfg.model, stop_threshold=2.0)
    cpu = M.init(mcfg, torch.Generator().manual_seed(SEED_TTS), "cpu")
    card = copy.deepcopy(cpu).cuda()
    g = torch.Generator().manual_seed(SEED_DATA)
    tokens = torch.randint(3, mcfg.vocab_size, (4, 64), generator=g)
    mask = torch.arange(64)[None, :] < torch.tensor([64, 40, 17, 64])[:, None]
    budgets = torch.tensor([64, 32, 64, 32])
    kw = dict(capacity_frames=64, slots=2, segment_frames=32)
    t0 = time.perf_counter()
    mel_c, len_c = serve_batch(cpu, mcfg, tokens, mask, budgets, **kw)
    cpu_s = time.perf_counter() - t0
    _reset_decode_counts()
    mel_g, len_g = serve_batch(card, mcfg, tokens.cuda(), mask.cuda(),
                               budgets.cuda(), **kw)
    n_flash = flash_attend.launches
    err = _scaled_err(mel_g, mel_c)
    same = bool((len_g.cpu() == len_c).all())
    print(f"[serving] (e) serve_batch f32 at 2 + 2 layers, 4 requests in 2 "
          f"slots: card (K1 {n_flash} launches) vs CPU (cpu {cpu_s:.1f} s): "
          f"mel err {err:.3e}, lengths equal {same}; tol {SLICE_TOL:g}")
    _require(same and err <= SLICE_TOL and n_flash >= 2,
             "serve_batch card and CPU disagree")


def _serve_pool_serving_fast():
    """(g) serving_fast.yaml as shipped (e4m3 rings, LSH encoder, prenet
    dropout on): serve_pool on 8 requests of 256 frames."""
    cfg = serving_config(SERVING_FAST_CONFIG)
    mcfg = cfg.model
    _require(TD._kv_dtype(mcfg, torch.bfloat16) == torch.float8_e4m3fn,
             "serving_fast does not resolve an e4m3 cache")
    tts = TD._precast_weights(
        M.init(mcfg, torch.Generator().manual_seed(SEED_TTS), "cuda"),
        torch.bfloat16)
    tokens, mask = _bench_inputs(cfg, 8, 256)
    _reset_decode_counts()
    t0 = time.perf_counter()
    mels, lengths = serve_pool(tts, mcfg, tokens.cpu().numpy(),
                               mask.cpu().numpy(), [256] * 8,
                               stop_threshold=2.0)
    wall = time.perf_counter() - t0
    counts = _decode_counts()
    stacked = torch.stack(mels)
    print(f"[serving] (g) serve_pool at serving_fast.yaml (e4m3 rings), 8 x "
          f"256 frames: {wall:.3f} s = {8 * 256 / wall:.1f} frames/s, "
          f"lengths {lengths.tolist()}, launches {counts}")
    n_enc = mcfg.encoder.num_layers
    _require(tuple(stacked.shape) == (8, 256, mcfg.n_mels)
             and bool(torch.isfinite(stacked).all())
             and lengths.tolist() == [256] * 8
             and counts["lsh_attend"] >= n_enc
             and counts["sort_by_bucket"] >= n_enc,
             "serve_pool at serving_fast")
    del tts
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    kind = phase_device()
    phase_build()
    errs = phase_kernels()
    cfg = base_config()
    syn, launches = phase_slice(cfg)
    phase_card_vs_cpu(cfg)
    times = phase_timing(syn)
    phase_profile(syn)
    del syn
    errs.update(phase_kernels_train())
    model, train_launches = phase_train()
    phase_train_card_vs_cpu()
    train_times = phase_train_timing(model)
    del model
    torch.cuda.empty_cache()
    errs.update(phase_kernels_lsh())
    model, lsh_launches = phase_train_lsh()
    phase_train_lsh_card_vs_cpu()
    lsh_times = phase_train_lsh_timing(model)
    del model
    torch.cuda.empty_cache()
    errs.update(phase_kernels_ffn())
    model, ffn_launches = phase_train_serving_fast()
    phase_train_serving_fast_card_vs_cpu()
    ffn_times = phase_train_serving_fast_timing(model)
    del model
    torch.cuda.empty_cache()
    errs.update(phase_kernels_sort())
    sort_launches, sort_times = phase_sort_probe()
    torch.cuda.empty_cache()
    errs.update(phase_kernels_vocoder_train())
    model, voc_launches = phase_train_vocoder()
    phase_train_vocoder_card_vs_cpu()
    voc_times = phase_train_vocoder_timing(model)
    del model
    torch.cuda.empty_cache()
    phase_audio()
    phase_serving_longform()
    phase_serving_fast()
    local_launches, local_times, local_errs = phase_parity_local()
    phase_decode_syncs()
    serve_launches, serve_times = phase_serving()
    _require(not any(m.split(".")[0] in ("jax", "rtts") for m in sys.modules
                     if sys.modules[m] is not None),
             "jax or the JAX package was imported")
    # serving kernels: launches of one Synthesizer call, times at the
    # encoder's shape and the serving vocoder's (1, 1024, 128); base.yaml
    # training kernels ("flash_train" is K1 in the train step): launches of
    # its three train steps, times and errors at the decoder's
    # self-attention shape (plain_ms of each K3 kernel: the plain backward,
    # all three gradients); "flash_cross", K1 again: launches of the three
    # longform train steps, times and error at the longform decoder's
    # cross-attention, where F.scaled_dot_product_attention's forward
    # computes its function (library_ms); LSH kernels: launches of the
    # three longform train steps, times at the longform decoder shape; K6:
    # launches of the three serving_fast steps with K6, times at the
    # decoder's FFN shape; K7's path entry ("sort_by_bucket"): launches of
    # the three longform train steps, times at the longform decoder's
    # buckets; K7's column entry ("bitonic_sort") and K8: launches of the
    # sort probe's run, times at the longform shapes; K2 in vocoder
    # training ("depthwise_train"): launches of phase 22's three train
    # steps, times and error at their (8, 128, 128) bf16 shape; K4 and K5
    # on parity_local's local layers ("lsh_attend_local",
    # "lsh_attend_bwd_local"): their launches in phase 28's three train
    # steps, times and errors at that shape; K1 and K2 on the continuous
    # path ("flash_serve", "depthwise_serve"): their launches in phase
    # 30(a)'s serve_continuous, times and errors at its admission encode
    # and its largest class's batched vocode
    launches.update(train_launches)
    launches.update(lsh_launches)
    launches.update(ffn_launches)
    launches.update(sort_launches)
    launches.update(voc_launches)
    launches.update(local_launches)
    times.update(train_times["decoder"])
    times["flash_cross"] = lsh_times.pop("cross")["flash_train"]
    times.update(lsh_times)
    times.update(ffn_times)
    times.update(sort_times)
    times.update(voc_times)
    times.update(local_times)
    errs.update(local_errs)
    launches.update(serve_launches)
    times.update(serve_times)
    errs.update({k: v["max_abs_err"] for k, v in serve_times.items()})
    meta = {
        "flash": ("rtts_torch/csrc/flash_fwd.cu",
                  "rtts/ops/flash_attention.py:322"),
        "depthwise": ("rtts_torch/csrc/depthwise_conv.cu",
                      "rtts/ops/depthwise_conv.py:29"),
        "flash_train": ("rtts_torch/csrc/flash_fwd.cu",
                        "rtts/ops/flash_attention.py:322"),
        "flash_cross": ("rtts_torch/csrc/flash_fwd.cu",
                        "rtts/ops/flash_attention.py:322"),
        "flash_bwd_dkv": ("rtts_torch/csrc/flash_bwd.cu",
                          "rtts/ops/flash_attention.py:509"),
        "flash_bwd_dq": ("rtts_torch/csrc/flash_bwd.cu",
                         "rtts/ops/flash_attention.py:553"),
        "lsh_attend": ("rtts_torch/csrc/lsh_attend_fwd.cu",
                       "rtts/ops/lsh_attention.py:60"),
        "lsh_attend_bwd": ("rtts_torch/csrc/lsh_attend_bwd.cu",
                           "rtts/ops/lsh_attention.py:158"),
        "ffn_fused": ("rtts_torch/csrc/ffn_fused.cu",
                      "rtts/ops/chunked_ffn.py:34"),
        "sort_by_bucket": ("rtts_torch/csrc/bitonic_sort.cu",
                           "scripts/probe_vmem_sort.py:45"),
        "bitonic_sort": ("rtts_torch/csrc/bitonic_sort.cu",
                         "scripts/probe_vmem_sort.py:45"),
        "row_gather": ("rtts_torch/csrc/row_gather.cu",
                       "scripts/probe_vmem_sort.py:85"),
        "depthwise_train": ("rtts_torch/csrc/depthwise_conv.cu",
                            "rtts/ops/depthwise_conv.py:29"),
        "lsh_attend_local": ("rtts_torch/csrc/lsh_attend_fwd.cu",
                             "rtts/ops/lsh_attention.py:60"),
        "lsh_attend_bwd_local": ("rtts_torch/csrc/lsh_attend_bwd.cu",
                                 "rtts/ops/lsh_attention.py:158"),
        "flash_serve": ("rtts_torch/csrc/flash_fwd.cu",
                        "rtts/ops/flash_attention.py:322"),
        "depthwise_serve": ("rtts_torch/csrc/depthwise_conv.cu",
                            "rtts/ops/depthwise_conv.py:29"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": errs[name],
                **{key: times[name][key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "device_ms")}}
               for name, (src, rep) in meta.items()]
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
