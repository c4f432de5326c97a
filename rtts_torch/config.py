"""Configuration of the port: a copy of ``rtts/config.py``.

The frozen dataclass tree (dataset / model / vocoder / experiment), the
strict ``from_dict``, ``to_dict``, dot-path ``apply_overrides``, YAML load
and save with no PyYAML (``load_yaml`` reads the config files' subset of
YAML through ``rtts_torch/yaml_subset.py``, as ``yaml.safe_load`` would;
``save_config`` writes the tree in YAML's flow style) and the
attention-kind resolver, with the same field
names and defaults: a YAML file means the same model to both packages
(``tests/test_torch_copies.py`` holds them equal).  What differs:
``resolve_reversible`` and ``resolve_ffn_chunk`` estimate memory with the
port's ``resolve_flash_impl`` (the card's K1 owns full attention at every
length), not the JAX flash resolver.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import typing
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple, Union

from rtts_torch.ops.flash_attention import resolve_flash_impl
from rtts_torch.yaml_subset import safe_load


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AudioConfig:
    """STFT / mel-spectrogram front-end parameters (tacotron-style)."""

    sample_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = 8000.0
    # log-compression floor: mel = log(max(linear, floor))
    log_floor: float = 1e-5
    center: bool = True


@dataclass(frozen=True)
class TextConfig:
    """Text frontend: cleaning + tokenization to a fixed symbol set."""

    cleaner: str = "english"          # "english" | "basic" | "identity"
    level: str = "char"               # "char" | "phoneme" (ARPAbet input)
    # (casing is the cleaner's job — the symbol table is lowercase-only, so
    # a separate lowercase knob would be a dead/lying switch; removed)
    # pad/eos ids are fixed by the symbol table (pad=0, eos=1)
    max_len: int = 512                # static-shape budget for token ids
    pad_to_multiple: int = 64         # LSH chunk alignment for encoder input


@dataclass(frozen=True)
class DatasetConfig:
    data_dir: str = "data"
    manifest: str = "manifest.json"
    split_seed: int = 0
    val_fraction: float = 0.05
    # static-shape batching buckets (token_len, mel_len) pairs
    mel_pad_to_multiple: int = 64
    max_mel_len: int = 1024
    batch_size: int = 8
    num_workers: int = 0              # >0 uses the native C++ loader if built
    shuffle_seed: int = 0
    audio: AudioConfig = field(default_factory=AudioConfig)
    text: TextConfig = field(default_factory=TextConfig)


@dataclass(frozen=True)
class AttentionConfig:
    """Reformer attention knobs (verified surface, SURVEY.md §3.2).

    Choosing ``kind`` for TRAINING throughput (measured, BENCH.md
    "Training attention" + r3 flash train sweep): flash-backed full
    softmax is the fastest option at every measured length through 32k
    frames (2-4x over 4-hash LSH at <=4k, 2.1-3.7x at 8k-16k, 1.4-1.8x at
    32k) AND uses less transient memory than LSH there (the flash backward
    re-streams tiles instead of storing scores); naive full (flash: false)
    collapses past ~4k where its (B,H,L,L) score
    tensors become pure HBM traffic.  LSH remains the choice beyond the
    flash-measured range (>32k; extrapolated crossover ~64k), for the
    O(chunk) ring-cache decode at 8k+ frames, and for sequence-parallel
    sharding."""

    # "full" | "lsh" | "local" | "auto".  "auto" resolves per apply by
    # sequence length: full softmax at L <= the auto-full limit, LSH above
    # — encoding the measured v5e crossovers (BENCH.md: with the flash
    # kernel, full beats 4-hash LSH at every measured length through 32k;
    # without it, naive full's (B,H,L,L) scores collapse past 4k while
    # LSH is 6.7x faster at 8k).  Resolution is static (shapes are static
    # under jit), so each bucketed length compiles its best kernel; decode
    # resolves at max_frames.
    kind: str = "lsh"
    num_heads: int = 8
    head_dim: int = 64
    num_hashes: int = 4
    # None => auto (2*L/chunk rounded to pow2); int => that many buckets;
    # list of even factors => factorized hashing (mixed-radix combine) for
    # very large bucket counts (reference config surface: int or 2-list)
    num_buckets: Union[int, List[int], None] = None
    chunk_length: int = 64
    num_chunks_before: int = 1
    num_chunks_after: int = 0
    hash_seed: Optional[int] = None   # fixed seed => deterministic LSH (tests)
    # kind="auto" crossover: longest sequence that still uses full softmax.
    # None => measured default, resolved purely from this config (so the
    # same config + length picks the same kind on every backend): 32768
    # when the flash kernel can own the full path (flash not disabled —
    # BENCH.md r3 flash train sweep + r4 32k cell: flash full beats 4-hash
    # LSH 2.1-3.7x at 8k-16k and 1.4-1.8x at 32k, and its transient memory
    # is BELOW LSH's; attention-probs
    # dropout runs in-kernel so it does not change this), else 4096, the
    # naive-full boundary (full 1.9x faster at 4k, LSH 6.7x at 8k —
    # BENCH.md "Training attention"; naive full's transient (B,H,L,L)
    # f32 scores collapse beyond that).  Set an int to pin the boundary
    # on memory-tight or unmeasured configs.
    auto_full_max_len: Optional[int] = None
    # how the bucket sort permutes q/k/v rows (BENCH.md r3 "LSH gather"):
    # "onehot" realizes the permutation as an MXU matmul against an
    # iota-compare one-hot — 2.3x faster forward than take_along_axis on
    # v5e and its backward is another matmul instead of a scatter-add
    # (bit-exact: one matched element per row); "take" is the gather
    # formulation (linear in L — wins when the one-hot would be huge);
    # "auto" picks onehot while the per-round permutation matrix stays
    # under ~4 GB (measured winner through 2 GB; 8k longform stays take).
    sort_gather: str = "auto"
    # attention-probs dropout (the reference lineage's LSHAttention dropout):
    # applied after the softmax in full/lsh/local self-attention and
    # cross-attention when training (deterministic=False); keys derive from
    # the per-layer aux rng, so the reversible backward replays the exact
    # mask.  On the flash kernel it runs IN-KERNEL from a counter-based
    # hash (a different — equally valid — sample than the naive path's
    # bernoulli draw; rtts/ops/flash_attention.py module docstring).
    # Not supported on the seq-parallel path (explicit error).
    attention_dropout: float = 0.0
    # mask penalty asymmetry (reference semantics): hard mask vs self-attend
    mask_value: float = -1e9
    self_mask_value: float = -1e5
    # fused Pallas chunk-attend kernel (falls back to interpret mode
    # off-TPU): true | false | "auto".  Measured on v5e: at flagship
    # shapes (L=1024) the attend op is HBM-bandwidth-bound and XLA's
    # fused path wins (best 3.2 ms vs 1.57 ms, BENCH.md r2 — Pallas DMA
    # streams reach ~half of XLA's effective bandwidth here), but at 8k
    # the balance flips: the kernel's in-VMEM scores took the longform
    # train step 27.3k -> 29.1k f/s and stacked with plain residuals to
    # 41.9k (BENCH.md r4 "8k step sweep").  "auto" = kernel on TPU from
    # 8192 positions (the measured win; 1024 measured a loss; between is
    # unmeasured so auto stays conservative), XLA below.  The kernel is
    # also more accurate (f32-accumulated scores, 10x closer to the f32
    # oracle than XLA's bf16 path).
    # In the port (rtts_torch/attention/lsh.py::_pick_attend_fn), true and
    # "auto" take the CUDA kernels K4/K5 at every length: the TPU's
    # 8192-position gate is not carried over.
    use_pallas: Union[bool, str] = "auto"
    # flash (online-softmax) Pallas kernel for the FULL-attention paths
    # (kind full / auto->full self-attention and cross-attention):
    # true | false | "auto".  Unlike the retired chunk-
    # attend kernel this one CUTS bytes (no (B,H,L,L) score tensor in HBM)
    # instead of restreaming them, so the Pallas half-bandwidth ceiling
    # does not apply.  "auto" = flash on TPU when one side is >= 1024
    # positions (non-128-multiple lengths pad transparently; attention
    # dropout runs in-kernel;
    # rtts/ops/flash_attention.py::resolve_flash_impl).  In the port, true
    # and "auto" take the CUDA kernel K1 at every length
    # (rtts_torch/ops/flash_attention.py::resolve_flash_impl).
    flash: Union[bool, str] = "auto"


@dataclass(frozen=True)
class ReformerStackConfig:
    """One Reformer encoder or decoder stack."""

    num_layers: int = 6
    d_model: int = 512
    d_ff: int = 2048
    # FFN length-chunking (the Reformer lineage's chunked feed-forward):
    # 0 => one unchunked matmul; N => remat over N-frame chunks via
    # lax.map (O(chunk) FFN-hidden transient, for the reversible memory
    # regime); "auto" => chunk (AUTO_FFN_CHUNK) only when the residual
    # scheme resolves REVERSIBLE for the apply shapes — under plain
    # residuals the remat buys no memory and the serialized chunks cost
    # ~5% of the flagship train step (BENCH.md r3 "step parts").
    ffn_chunk_size: Union[int, str] = 0
    ffn_activation: str = "gelu"
    dropout: float = 0.1
    # True | False | "auto".  Reversible residuals give O(1) activation
    # memory in depth (SURVEY.md §3.2) at the cost of re-running every
    # sublayer in the backward (recompute ~ +1x forward).  Both paths run
    # the identical two-stream forward (rtts/reversible/rev.py), so this
    # is purely a speed/memory knob.  "auto" resolves per apply from the
    # static shapes: plain residuals while the estimated plain-path
    # transient HBM stays under auto_plain_budget_mb, reversible above
    # (the measured-crossover doctrine of attention kind="auto";
    # BENCH.md r3 "reversible vs plain").
    reversible: Union[bool, str] = True
    # kind="auto" budget for resolve_reversible, per stack: an estimate of
    # the plain path's transient activation HBM (attention scores + FFN
    # hiddens, see _plain_transient_mb) is compared against this.  4 GB per
    # stack keeps a flagship train step well inside one v5e's 16 GB
    # together with params/optimizer state; raise it on larger chips.
    auto_plain_budget_mb: int = 4096
    causal: bool = False
    # (a residual_dtype="bfloat16" stream knob was probed and REJECTED:
    # +9% step time at flagship — the f32<->bf16 round-trips around the
    # f32 LN internals cost more than the stream bytes save; BENCH.md r3
    # "step parts".  Streams ride f32, the torch-AMP-equivalent numerics
    # the fidelity contract mirrors.)
    # fused LN+FFN kernel: measured a wash on v5e (0.95-1.01x vs XLA,
    # BENCH.md r2) — default OFF, available for accuracy-sensitive runs
    use_pallas_ffn: bool = False
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    # optional per-layer attention kinds (e.g. ["local","lsh","local","lsh"]
    # — the reference lineage's interleaved attn_layers); None => all layers
    # use attention.kind
    attn_layers: Optional[List[str]] = None
    # sequence parallelism (SURVEY.md §6.7): mesh axis to shard the sequence
    # over for LSH self-attention (None = single-device algorithmic path);
    # exchange: "allgather" (one hop, O(L·d) transient HBM) or "ring"
    # (n-1 neighbor hops, O(L·d/n) transient HBM)
    seq_parallel_axis: Optional[str] = None
    seq_parallel_exchange: str = "allgather"
    # pipeline parallelism (beyond reference — PARITY.md §3.4): mesh axis
    # to stage the stack's layers over (GPipe fill/drain via scan +
    # ppermute, rtts/parallel/pipeline.py).  Mutually exclusive with
    # seq_parallel_axis per stack; requires uniform attention kind and
    # num_layers % n_stages == 0.  microbatches: 0 => one per stage
    # (bubble fraction (S-1)/(M+S-1)); remat: recompute each stage tick
    # in the backward (O(1) saved activations per tick)
    pipeline_axis: Optional[str] = None
    pipeline_microbatches: int = 0
    pipeline_remat: bool = True
    # virtual stages per device (Megatron-style interleaved / circular
    # schedule): each device holds `v` non-contiguous layer chunks and the
    # activation makes `v` laps around the stage ring, shrinking the
    # bubble to (S-1)/(v*M + S-1) in ticks of 1/v the work — a v× smaller
    # bubble at FIXED microbatch size (the alternative, raising M, shrinks
    # microbatches and starves the MXU).  Needs num_layers % (v*S) == 0
    # and microbatches a multiple of S.  1 = plain GPipe.
    pipeline_interleave: int = 1


@dataclass(frozen=True)
class ReformerTTSConfig:
    """Seq2seq text->mel acoustic model (Transformer-TTS topology with
    Reformer stacks — SURVEY.md §3.1 #8)."""

    vocab_size: int = 0               # 0 => set from symbol table at build
    d_model: int = 512
    n_mels: int = 80
    encoder: ReformerStackConfig = field(
        default_factory=lambda: ReformerStackConfig(causal=False)
    )
    decoder: ReformerStackConfig = field(
        default_factory=lambda: ReformerStackConfig(causal=True)
    )
    # encoder prenet: conv stack over embeddings
    enc_prenet_layers: int = 3
    enc_prenet_kernel: int = 5
    enc_prenet_dropout: float = 0.1
    # decoder prenet: 2-layer bottleneck MLP on mel frames
    dec_prenet_hidden: int = 256
    dec_prenet_dropout: float = 0.5
    # postnet: conv residual refiner
    postnet_layers: int = 5
    postnet_channels: int = 512
    postnet_kernel: int = 5
    postnet_dropout: float = 0.1
    # positional encoding
    pos_encoding: str = "scaled_sinusoidal"  # or "axial"
    axial_pos_shape: Tuple[int, int] = (32, 32)
    axial_pos_dims: Tuple[int, int] = (256, 256)
    max_pos: int = 4096
    # stop token head
    stop_threshold: float = 0.5
    stop_pos_weight: float = 8.0      # BCE positive-class weight (rare stops)
    # guided attention (beyond-reference, opt-in): soft-diagonal prior on the
    # decoder cross-attention (Tachibana et al. 2017, DC-TTS).  weight > 0
    # adds  w * mean(A[t,n] * (1 - exp(-(n/N - t/T)^2 / 2 sigma^2)))  to the
    # training loss, penalizing attention mass far from the diagonal —
    # accelerates alignment (the `attn_diagonality` eval scalar) and reduces
    # stop overruns on free-running decodes.  Requires plain residuals on
    # the decoder (the prob capture cannot cross the reversible custom_vjp
    # boundary) and is incompatible with pipeline_axis; cross-attention
    # layers run the naive (prob-materializing) path while enabled.
    guided_attention_weight: float = 0.0
    guided_attention_sigma: float = 0.2
    # > 0: linearly anneal the guided-attention weight to 0 over this many
    # steps (prior strongest early, unconstrained late).  The probability
    # capture (naive cross path) stays active for the whole run — size the
    # decay to most of training or restart without the knob after it hits 0.
    guided_attention_decay_steps: int = 0
    # frames emitted per decoder step (Tacotron-lineage "outputs per step"):
    # r>1 cuts AR decode steps by r; r=1 is the reference-exact default
    reduction_factor: int = 1
    # dtype policy
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # serving KV-cache storage dtype: "compute" (default) stores decode
    # K/V caches + cross-attention memory in compute_dtype;
    # "float8_e4m3fn" halves the dominant per-step HBM stream of AR
    # decoding (the cache re-read) at ~8x coarser key/value rounding —
    # opt-in, fidelity quantified in BENCH.md/PARITY.md.  Training is
    # unaffected (the knob only touches rtts/infer/decode.py buffers).
    kv_cache_dtype: str = "compute"


@dataclass(frozen=True)
class SqueezeWaveConfig:
    """SqueezeWave flow vocoder (SURVEY.md §3.1 #11)."""

    n_mels: int = 80
    n_flows: int = 12
    n_group: int = 128                # audio samples squeezed per frame
    n_early_every: int = 4
    n_early_size: int = 16
    wn_layers: int = 8
    wn_channels: int = 128
    wn_kernel_size: int = 3
    sigma: float = 1.0
    sample_rate: int = 22050
    hop_length: int = 256
    audio_segment_length: int = 16384  # random crop length for training
    # fused Pallas depthwise-conv kernel.  Default OFF as of round 3: the
    # same-process interleaved A/B at serving shapes (bf16, folded
    # weights; BENCH.md r3 "depthwise conv verdict") measures median pair
    # speedups 1.04/1.00/1.11 with a +-40% spread — the speed claim is
    # inside the noise band, the same standard that retired the attend
    # and FFN kernels.  The kernel stays available and tested; it is
    # bit-exact in f32 where XLA's conv is approximate (1.75e-2), so
    # accuracy-sensitive runs can switch it on.
    use_pallas: bool = False
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # Soft bound on the coupling log-scale: log_s <- clamp*tanh(log_s/clamp),
    # applied identically in forward and inverse (invertibility preserved).
    # 0 disables (exact WaveGlow semantics).  Needed on near-deterministic
    # synthetic corpora where the NLL is unbounded below: the 20k-step
    # flagship vocoder run diverged at step ~1800 (log_s_mean ~9 -> forward
    # overflow -> NaN) even at f32 compute, LR 1e-4, grad-clip 1.0.
    log_s_clamp: float = 0.0


@dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adam"
    learning_rate: float = 1e-4
    warmup_steps: int = 4000
    schedule: str = "noam"            # "noam" | "constant" | "cosine"
    total_steps: int = 100_000
    weight_decay: float = 0.0
    grad_clip_norm: float = 1.0
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1e-9
    # Gradient accumulation (SURVEY.md §3.1 #14: the reference's Lightning
    # trainer exposes accumulate_grad_batches; here it is an optimizer
    # property via optax.MultiSteps).  >1 => every optimizer update
    # consumes the MEAN gradient of that many consecutive micro-batches —
    # an effective batch of accumulate_steps * batch_size on the same HBM
    # footprint.  Clipping and the LR schedule act per optimizer update
    # (warmup_steps counts updates, not micro-steps), matching Lightning's
    # semantics of clipping the accumulated gradient.
    accumulate_steps: int = 1


@dataclass(frozen=True)
class MeshConfig:
    """SPMD device-mesh layout + multi-host init (SURVEY.md §6.8)."""

    data_axis: str = "data"
    model_axis: str = "model"
    dcn_axis: str = "dcn"
    # -1 => use all available devices along the data axis
    data_parallel: int = -1
    model_parallel: int = 1
    # >1 adds an outermost cross-slice (DCN) data-parallel axis
    dcn_parallel: int = 1
    # ZeRO-1: shard optimizer moments over the data axis (each DP rank
    # holds 1/dp of the Adam state; XLA emits the update all-gather).
    # Numerics identical to replicated (tests/test_zero_sharding.py)
    zero_sharding: bool = False
    # multi-host: set coordinator_address (host:port) and num_processes /
    # process_id per host, or rely on cluster env auto-detection
    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str = "checkpoints"
    keep: int = 3
    save_every_steps: int = 1000
    resume: bool = True
    # overlap the npz write/retention with training on a worker thread
    # (AsyncCheckpointer): the tree is snapshotted to host before the
    # train step's donated buffers can overwrite it, and the trainer
    # flushes before exiting, so resume semantics are identical
    async_save: bool = True


@dataclass(frozen=True)
class LoggingConfig:
    jsonl_path: str = "metrics.jsonl"
    tensorboard_dir: Optional[str] = None
    # optional hosted experiment tracker (SURVEY.md §3.1 #18): "neptune",
    # "wandb", or a "module.path:factory" dotted path; degrades to a
    # warning + local-sinks-only when the SDK/network is absent
    # (rtts/utils/tracking.py)
    tracker: Optional[str] = None
    log_every_steps: int = 50
    eval_every_steps: int = 500
    artifacts_dir: str = "artifacts"  # spectrogram PNGs + wavs at eval


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "default"
    seed: int = 0
    max_steps: int = 10_000
    eval_batches: int = 4
    # numerical sanitizer (SURVEY.md §6.2): raise on NaNs inside jit
    debug_nans: bool = False
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)


@dataclass(frozen=True)
class Config:
    """Root config — one YAML file maps onto this tree."""

    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ReformerTTSConfig = field(default_factory=ReformerTTSConfig)
    vocoder: SqueezeWaveConfig = field(default_factory=SqueezeWaveConfig)
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)


# kind="auto" boundaries, measured on v5e (BENCH.md).  Flash-backed full
# attention beats 4-hash LSH at every measured length through 32k — the
# b1x32768 cell (r4): flash 41.4k f/s reversible / 54.2k plain vs LSH
# 30.5k, a 1.4-1.8x win — so 32768 is the longest MEASURED win.
# Extrapolating flash's per-frame cost doubling per length doubling
# against LSH's flat ~30k f/s puts the true crossover near 64k.  Naive
# full (flash: false) collapses between 4k and 8k on (B,H,L,L) f32
# score traffic.
AUTO_FULL_MAX_LEN_FLASH = 32768
AUTO_FULL_MAX_LEN_NAIVE = 4096


def auto_full_limit(a: "AttentionConfig") -> int:
    """The longest sequence kind="auto" resolves to full softmax.

    A pure function of the config — deliberately independent of the
    runtime platform, so a checkpoint's attention semantics never change
    between TPU training and CPU tests/eval.  Flash "capability" here
    means the config permits the kernel (flash not false; attention-probs
    dropout runs in-kernel so it does not gate); off-TPU the full path
    simply runs naive (or interpret mode) at the same semantics."""
    if a.auto_full_max_len is not None:
        return a.auto_full_max_len
    flash_capable = a.flash not in (False, None)
    return AUTO_FULL_MAX_LEN_FLASH if flash_capable else AUTO_FULL_MAX_LEN_NAIVE


def resolve_attention_kind(a: "AttentionConfig", seq_len: int) -> str:
    """Resolve kind="auto" for a given (static) sequence length.

    The rule encodes the measured training crossovers (BENCH.md): with
    the flash kernel the MXU makes O(L^2) full-softmax scores cheaper
    than LSH's sort/gather machinery through 32k positions on v5e;
    without it (flash: false) naive full wins only to ~4k, past which
    its (B,H,L,L) score traffic collapses and LSH's O(L log L) wins
    outright."""
    if a.kind != "auto":
        return a.kind
    return "full" if seq_len <= auto_full_limit(a) else "lsh"


# ffn_chunk_size="auto" chunk width: 256 frames matches the shipped
# explicit configs and keeps the FFN hidden transient per chunk at
# chunk * d_ff * 4B (0.5 MB at d_ff 2048) in the reversible regime.
AUTO_FFN_CHUNK = 256


def _plain_transient_mb(cfg: ReformerStackConfig, batch: int, seq_len: int,
                        mem_len: Optional[int] = None) -> float:
    """Rough transient memory (MB) of the plain-residual train step of one
    stack: ``rtts/config.py::_plain_transient_mb`` term for term.  Flash
    attention stores O(L d) per layer, naive full attention its (B, H, L,
    L) f32 probabilities; each FFN its (B, L, d_ff) hidden."""
    a = cfg.attention
    f32 = 4.0
    flash = resolve_flash_impl(a.flash) == "flash"
    kinds = (list(cfg.attn_layers) if cfg.attn_layers is not None
             else [a.kind] * cfg.num_layers)
    total = 0.0
    for kind in kinds:
        if kind == "auto":
            kind = resolve_attention_kind(a, seq_len)
        if kind == "full":
            if flash:
                total += (batch * a.num_heads * seq_len
                          * (4 * a.head_dim + 128) * f32)
            else:
                total += batch * a.num_heads * seq_len * seq_len * f32
        elif kind == "lsh":
            total += (batch * a.num_heads * a.num_hashes * seq_len
                      * a.head_dim * f32 * 8)
        else:  # local: windowed scores per chunk
            window = (1 + a.num_chunks_before + a.num_chunks_after)
            total += (batch * a.num_heads * seq_len * a.chunk_length
                      * window * f32 * 2)
        total += batch * seq_len * cfg.d_ff * f32          # FFN hidden
        if mem_len is not None:                            # cross-attn pair
            if flash:
                total += (batch * a.num_heads * (seq_len + mem_len)
                          * (2 * a.head_dim + 64) * f32)
            else:
                total += batch * a.num_heads * seq_len * mem_len * f32
            total += batch * seq_len * cfg.d_ff * f32
    return total / 1e6


def resolve_reversible(cfg: ReformerStackConfig, batch: int, seq_len: int,
                       mem_len: Optional[int] = None) -> bool:
    """Resolve reversible="auto" for the given apply shapes, with the rule
    of ``rtts/config.py::resolve_reversible``: plain residuals while the
    estimated plain transient stays under ``auto_plain_budget_mb``."""
    if isinstance(cfg.reversible, bool):
        return cfg.reversible
    if cfg.reversible != "auto":
        raise ValueError(
            f"reversible must be true, false or 'auto', got {cfg.reversible!r}")
    return (_plain_transient_mb(cfg, batch, seq_len, mem_len)
            > cfg.auto_plain_budget_mb)


def resolve_ffn_chunk(cfg: ReformerStackConfig, batch: int, seq_len: int,
                      mem_len: Optional[int] = None) -> int:
    """Resolve ffn_chunk_size for the given apply shapes: "auto" chunks
    (AUTO_FFN_CHUNK) exactly when the residuals resolve reversible."""
    c = cfg.ffn_chunk_size
    if isinstance(c, str):
        if c != "auto":
            raise ValueError(
                f"ffn_chunk_size must be an int or 'auto', got {c!r}")
        return (AUTO_FFN_CHUNK
                if resolve_reversible(cfg, batch, seq_len, mem_len) else 0)
    if c < 0:
        raise ValueError(f"ffn_chunk_size must be >= 0, got {c}")
    return c


# ---------------------------------------------------------------------------
# from_dict / to_dict / YAML / overrides — self-contained (no dacite dep)
# ---------------------------------------------------------------------------


def _is_optional(tp) -> bool:
    return typing.get_origin(tp) is Union and type(None) in typing.get_args(tp)


def _unwrap_optional(tp):
    args = [a for a in typing.get_args(tp) if a is not type(None)]
    return args[0] if len(args) == 1 else Union[tuple(args)]


def _coerce(value: Any, tp) -> Any:
    """Coerce a plain python value into the annotated type."""
    if tp is Any:
        return value
    if _is_optional(tp):
        if value is None:
            return None
        return _coerce(value, _unwrap_optional(tp))
    origin = typing.get_origin(tp)
    if origin is Union:
        # non-Optional Union (e.g. num_buckets: int | List[int]): the value
        # must coerce under at least ONE member — don't let it bypass the
        # strict checking every plain field gets
        errs = []
        for member in typing.get_args(tp):
            try:
                return _coerce(value, member)
            except (TypeError, ValueError, KeyError) as e:
                errs.append(str(e))
        raise TypeError(f"value {value!r} matches no member of {tp}: {errs}")
    if dataclasses.is_dataclass(tp):
        if isinstance(value, tp):
            return value
        if not isinstance(value, dict):
            raise TypeError(f"expected mapping for {tp.__name__}, got {value!r}")
        return from_dict(tp, value)
    if origin in (list, List):
        if not isinstance(value, (list, tuple)):
            raise TypeError(f"expected list, got {type(value).__name__}: "
                            f"{value!r}")
        (elem_tp,) = typing.get_args(tp) or (Any,)
        return [_coerce(v, elem_tp) for v in value]
    if origin in (tuple, Tuple):
        if not isinstance(value, (list, tuple)):
            raise TypeError(f"expected list/tuple, got "
                            f"{type(value).__name__}: {value!r}")
        args = typing.get_args(tp)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(v, args[0]) for v in value)
        if len(value) != len(args):   # zip would silently truncate
            raise TypeError(f"expected {len(args)} elements for {tp}, "
                            f"got {len(value)}: {value!r}")
        return tuple(_coerce(v, t) for v, t in zip(value, args))
    if tp in (int, float) and isinstance(value, bool):
        # bool is an int subclass: `num_layers: true` must not mean 1
        raise TypeError(f"expected {tp.__name__}, got bool: {value!r}")
    if tp is float and isinstance(value, int):
        return float(value)
    if tp is int and isinstance(value, float) and value.is_integer():
        return int(value)
    if tp in (int, float, str, bool) and not isinstance(value, tp):
        raise TypeError(f"expected {tp.__name__}, got {type(value).__name__}: {value!r}")
    return value


def from_dict(cls, data: dict):
    """Build a dataclass instance from a nested dict, type-checking fields.

    Unknown keys are an error (catches config typos early, same posture as
    dacite's strict mode in the reference)."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _coerce(data[f.name], hints[f.name])
    return cls(**kwargs)


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _parse_scalar(text: str) -> Any:
    t = text.strip()
    low = t.lower()
    if low in ("null", "none", "~"):
        return None
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    if t.startswith("[") or t.startswith("{"):
        return json.loads(t)
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    return t


def load_yaml(path: Union[str, pathlib.Path]) -> dict:
    """The YAML file at ``path`` as ``yaml.safe_load`` reads it ({} when
    empty); constructs outside the config files' subset raise ValueError
    naming the line."""
    return safe_load(pathlib.Path(path).read_text(), str(path)) or {}


def apply_overrides(data: dict, overrides: List[str]) -> dict:
    """Apply ``a.b.c=value`` dot-path overrides onto a nested dict."""
    out = json.loads(json.dumps(data))  # deep copy
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key.path=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        node = out
        parts = key.strip().split(".")
        for i, p in enumerate(parts[:-1]):
            nxt = node.setdefault(p, {})
            if not isinstance(nxt, dict):
                # a YAML null/scalar at an intermediate path node: replace it
                # (overriding `model: null` with model.d_model=256 should
                # work, not AttributeError on None.setdefault)
                if nxt is None:
                    nxt = node[p] = {}
                else:
                    raise ValueError(
                        f"cannot override {key!r}: "
                        f"{'.'.join(parts[:i + 1])!r} is {nxt!r}, not a "
                        f"mapping")
            node = nxt
        node[parts[-1]] = _parse_scalar(raw)
    return out


def load_config(
    path: Optional[Union[str, pathlib.Path]] = None,
    overrides: Optional[List[str]] = None,
) -> Config:
    data = load_yaml(path) if path else {}
    if overrides:
        data = apply_overrides(data, overrides)
    return from_dict(Config, data)


def _flow_yaml(x: Any) -> str:
    """``x`` (a ``to_dict`` tree) in YAML's flow style: JSON, but with floats
    that YAML 1.1 reads as floats (1.0e-05, not 1e-05; .inf, .nan)."""
    if isinstance(x, dict):
        return "{" + ", ".join(f"{json.dumps(str(k))}: {_flow_yaml(v)}"
                               for k, v in x.items()) + "}"
    if isinstance(x, (list, tuple)):
        return "[" + ", ".join(_flow_yaml(v) for v in x) + "]"
    if isinstance(x, float):
        if x != x or x in (float("inf"), float("-inf")):
            return {"nan": ".nan", "inf": ".inf", "-inf": "-.inf"}[repr(x)]
        mantissa, e, exponent = repr(x).partition("e")
        if e and "." not in mantissa:
            mantissa += ".0"
        return mantissa + e + exponent
    return json.dumps(x)


def save_config(cfg: Config, path: Union[str, pathlib.Path]) -> None:
    """Write ``cfg`` as YAML in flow style, with no PyYAML needed (the
    trainers run where it is not installed); ``load_yaml`` reads it back to
    the same tree."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(_flow_yaml(to_dict(cfg)) + "\n")
