#!/usr/bin/env python3
"""Smoke run of the rtts_torch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's two paths at the full width of ``configs/base.yaml``
with random weights made from fixed seeds: serving
(``rtts_torch.infer.synthesize.Synthesizer``: text -> encoder -> kv_full
greedy decode -> postnet -> SqueezeWave inverse) and TTS training
(``rtts_torch.train.train_tts.make_train_step``: teacher-forced forward with
dropout, loss with guided attention, backward, clip, Adam, Noam), phase by
phase; every phase raises on failure:

1. device: the card's name and power limit;
2. build: nvcc builds the CUDA kernels from ``rtts_torch/csrc``;
3. kernels: K1 (flash-attention forward) and K2 (depthwise conv) on the card
   against their plain PyTorch versions, at the serving shapes;
4. slice: the Synthesizer answers 8 sentences with finite waveforms of the
   expected lengths, through both kernels (launch counters), and the same
   weights and noise at float32 on the card match the port on the CPU;
5. timing at the shape of ``rtts/bench.py::bench_e2e`` (batch 8, 256 tokens,
   512 frames, stop threshold 2.0, batched vocoder), and each kernel
   against its plain version;
6. profile: ``torch.profiler`` over a 64-frame decode at that shape, for
   the device's busy and idle share, the kernels per decode step and the
   ops that take the device time;
7. kernels-train: K1 with dropout and its lse, and K3 (the dK/dV and dQ
   kernels), against their plain versions at the training shapes, in bf16
   and f32, at dropout 0 and 0.1; the kernels' keep masks against
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
   their plain versions at the decoder and encoder shapes.

Prints a JSON line of per-kernel results and, last, the JSON result line.
Exits non-zero, printing no result, without a CUDA GPU.  Imports only the
port: no JAX and nothing of the JAX package (PyYAML is not needed either:
the base config is the dict below).
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from rtts_torch.config import Config, from_dict
from rtts_torch.infer.decode import decode_greedy
from rtts_torch.infer.synthesize import Synthesizer
from rtts_torch.models import reformer_tts as M
from rtts_torch.models import squeezewave as SW
from rtts_torch.ops import _build
from rtts_torch.ops.depthwise_conv import (depthwise_conv1d,
                                           depthwise_conv1d_reference)
from rtts_torch.ops.flash_attention import (dropout_keep_mask, flash_attend,
                                            flash_attend_bwd_reference,
                                            flash_attend_reference,
                                            flash_bwd_dkv, flash_bwd_dq,
                                            flash_fwd)
from rtts_torch.text import encode_batch, frontend_vocab_size
from rtts_torch.train.optim import make_optimizer
from rtts_torch.train.train_tts import make_train_step, step_generator

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
        if "registers" in line:
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


def _dw_case(shape, taps, dtype):
    g = torch.Generator().manual_seed(SEED_DATA)
    c = shape[-1]
    return (torch.randn(*shape, generator=g).to("cuda", dtype),
            torch.randn(taps, 1, c, generator=g).to("cuda", dtype),
            torch.randn(c, generator=g).to("cuda", dtype))


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
    for name, (shape, taps, dtype) in {
            "vocoder (8,1024,128) K3 bf16": ((8, 1024, 128), 3, bf),
            "vocoder (8,1024,128) K3 f32": ((8, 1024, 128), 3, f32),
            "(8,1024,128) K4 bf16": ((8, 1024, 128), 4, bf),
            "(2,77,6) K3 f32 scalar path": ((2, 77, 6), 3, f32)}.items():
        args = _dw_case(shape, taps, dtype)
        got = depthwise_conv1d(*args)
        torch.cuda.synchronize()
        want = depthwise_conv1d_reference(*args)
        err, abs_err = _scaled_err(got, want), _abs_err(got, want)
        tol = KERNEL_TOL[dtype]
        print(f"[kernels] K2 {name}: max err {err:.3e} (abs {abs_err:.3e}), "
              f"tol {tol:g}")
        _require(err <= tol, f"K2 {name} disagrees")
        main.setdefault("depthwise", abs_err)
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


def _kernel_ms(kernel, plain, n=200):
    """Kernel and plain version in turns (plain, kernel, kernel, plain),
    after a warm-up; mean ms per call of each."""
    for fn in (kernel, plain):
        _events_ms(fn, 10)
    p1, k1, k2, p2 = (_events_ms(f, n) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


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

    qkv, kw = _flash_case(8, 8, 256, 256, torch.bfloat16, ENCODER_LENS)
    flash_ms = _kernel_ms(lambda: flash_attend(*qkv, **kw),
                          lambda: flash_attend_reference(*qkv, **kw))
    dw = _dw_case((8, 1024, 128), 3, torch.bfloat16)
    dw_ms = _kernel_ms(lambda: depthwise_conv1d(*dw),
                       lambda: depthwise_conv1d_reference(*dw))
    print(f"[timing] K1 encoder shape b8 h8 L256 dh64 bf16: kernel "
          f"{flash_ms[0]:.4f} ms, plain {flash_ms[1]:.4f} ms")
    print(f"[timing] K2 vocoder shape (8,1024,128) K3 bf16: kernel "
          f"{dw_ms[0]:.4f} ms, plain {dw_ms[1]:.4f} ms")
    return {"flash": flash_ms, "depthwise": dw_ms}


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


def _profile(fn, top: int = 6):
    """Run ``fn`` (which ends in a synchronize) once under torch.profiler
    -> (wall s, device busy s, device activities, the top ops by device
    time as text).  The wall includes the profiler's own host overhead;
    device busy is the sum of the device activities it recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e6
    n_kernels = sum(e.count for e in device)
    _require(busy > 0 and n_kernels > 0, "the profiler saw no device work")
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)[:top]
    return wall, busy, n_kernels, ", ".join(
        f"{e.key} {e.self_device_time_total / 1e6 / busy:.1%}" for e in ops)


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
}


def train_config(compute_dtype: str = "bfloat16", num_layers=None,
                 dropout_off: bool = False, attention_dropout: float = 0.0,
                 **optim) -> Config:
    """base.yaml for training: ``num_layers`` cuts both stacks, and
    ``dropout_off`` sets every dropout rate to 0 (the decoder prenet's
    included), so two devices can take the same step."""
    data = copy.deepcopy(BASE_CONFIG)
    model = data["model"]
    model.update(vocab_size=frontend_vocab_size("char"),
                 compute_dtype=compute_dtype)
    for stack in (model["encoder"], model["decoder"]):
        stack["attention"]["attention_dropout"] = attention_dropout
        if num_layers is not None:
            stack["num_layers"] = num_layers
        if dropout_off:
            stack["dropout"] = 0.0
    if dropout_off:
        model.update(enc_prenet_dropout=0.0, dec_prenet_dropout=0.0,
                     postnet_dropout=0.0)
    data["experiment"]["optim"].update(optim)
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
    of each kernel at the first case (the encoder's, bf16, dropout 0)."""
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
                    main.setdefault(kernel, max(_abs_err(got[key], ref[key])
                                                for key in keys))
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
    init = M.init(cfg.model, torch.Generator().manual_seed(SEED_TTS))
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

    times = {}
    for name, case, n in (("decoder", "decoder b8 h8 L1024 causal+self", 20),
                          ("encoder", "encoder b8 h8 L256 self+pad", 100)):
        (q, k, v, dout), mask, opts = _train_flash_case(
            *TRAIN_FLASH_CASES[case], torch.bfloat16)
        args = (*opts, 0.0, 0)
        kw = dict(zip(("causal", "self_mask", "sm_scale", "q_offset"), opts))
        out, lse = flash_fwd(q, k, v, mask, *args)
        fwd = _kernel_ms(lambda: flash_fwd(q, k, v, mask, *args),
                         lambda: flash_attend_reference(
                             q, k, v, mask, return_lse=True, **kw), n)
        plain_bwd = lambda: flash_attend_bwd_reference(  # noqa: E731
            q, k, v, out, dout, lse, mask, **kw)
        dkv = _kernel_ms(lambda: flash_bwd_dkv(q, k, v, out, dout, lse, mask,
                                               *args), plain_bwd, n)
        dq = _kernel_ms(lambda: flash_bwd_dq(q, k, v, out, dout, lse, mask,
                                             *args), plain_bwd, n)
        print(f"[train-timing] {case} bf16: K1 fwd+lse {fwd[0]:.4f} ms (plain "
              f"{fwd[1]:.4f}); K3 dK/dV {dkv[0]:.4f} ms + dQ {dq[0]:.4f} ms = "
              f"{dkv[0] + dq[0]:.4f} ms (plain backward, all three "
              f"gradients: {dkv[1]:.4f} ms)")
        times[name] = {"flash_train": fwd, "flash_bwd_dkv": dkv,
                       "flash_bwd_dq": dq}
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    kind = phase_device()
    phase_build()
    errs = phase_kernels()
    cfg = base_config()
    syn, launches = phase_slice(cfg)
    phase_card_vs_cpu(cfg)
    times = phase_timing(syn)
    phase_profile(syn)
    train_errs = phase_kernels_train()
    model, train_launches = phase_train()
    phase_train_card_vs_cpu()
    train_times = phase_train_timing(model)
    _require("jax" not in sys.modules, "jax was imported")
    # serving kernels: launches of one Synthesizer call, times at the
    # encoder and vocoder shapes; training kernels ("flash_train" is K1 in
    # the train step): launches of the three base.yaml train steps, times
    # at the decoder's self-attention shape (plain_ms of each K3 kernel:
    # the plain backward, all three gradients)
    errs.update(train_errs)
    launches.update(train_launches)
    times.update(train_times["decoder"])
    meta = {
        "flash": ("rtts_torch/csrc/flash_fwd.cu",
                  "rtts/ops/flash_attention.py:322"),
        "depthwise": ("rtts_torch/csrc/depthwise_conv.cu",
                      "rtts/ops/depthwise_conv.py:29"),
        "flash_train": ("rtts_torch/csrc/flash_fwd.cu",
                        "rtts/ops/flash_attention.py:322"),
        "flash_bwd_dkv": ("rtts_torch/csrc/flash_bwd.cu",
                          "rtts/ops/flash_attention.py:509"),
        "flash_bwd_dq": ("rtts_torch/csrc/flash_bwd.cu",
                         "rtts/ops/flash_attention.py:553"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1]}
               for name, (src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
