"""Sort probe: would a fused sort (+ attend) pay for LSH attention on the card?

Counterpart of ``scripts/probe_vmem_sort.py``, the JAX package's probe of
whether an in-VMEM fused sort (+ attend) could beat LSH attention's sort and
permutation gather on a v5e TPU.  A fused kernel needs two primitives, here
the kernels K7 and K8:

- K7, ``rtts_torch/ops/bitonic_sort.py``: a column-wise bitonic sort of the
  packed keys ``bucket * L + pos`` (a value sort is the stable bucket sort,
  and key % L the permutation);
- K8, ``rtts_torch/ops/row_gather.py``: out[i] = x[idx[i]], the per-row
  dynamic-index access a fused sorted attend makes.

``check()`` holds both against numpy on the original's cases: on the card
the kernels, on the CPU their plain versions.  ``bench()`` runs on the card
(CUDA events after a warm-up, each candidate timed forward then reversed):

A. K7's column entry against ``torch.sort`` (values), ``torch.argsort`` +
   ``take_along_dim``, the LSH path's ``_sort_by_bucket`` (K7's path entry
   on the (B, H, nh, L) buckets) and its torch route
   ``sort_by_bucket_reference`` (``torch.sort`` + ``torch.argsort``);
B. K8 against the one-hot bf16 matmul (f32 accumulation), ``index_select``
   and the LSH path's ``_perm_rows_take``;
C. the LSH core's ``sort_gather`` modes, ``onehot`` against ``take``,
   forward + backward;

at the probe's own shape (L 4096, 128 key columns, gathers of 4096 rows of
128 and 256 f32), longform_8k.yaml's LSH shape (b2 h8 nh4 L8192: 64 columns,
gathers of (16, 32768, 128) bf16 packed qk + v) and serving_fast.yaml's (b8
h8 nh4 L1024: 256 columns, gathers of (64, 4096, 128)).  Then it profiles
one train step of each config and prints the verdict: a fused sort + attend
can save at most the share of the step's device time that ``aten::sort``,
``aten::argsort``, ``aten::gather`` and K7's path entry take, forward and
backward.

    python -m rtts_torch.probes.probe_vmem_sort            # bench, on the card
    python -m rtts_torch.probes.probe_vmem_sort --check    # the kernels
    python -m rtts_torch.probes.probe_vmem_sort --check --device cpu
"""

from __future__ import annotations

import argparse
import copy
import dataclasses

import numpy as np
import torch

from rtts_torch.attention import lsh as TL
from rtts_torch.config import AttentionConfig, Config, from_dict
from rtts_torch.models import reformer_tts as M
from rtts_torch.ops.bitonic_sort import (bitonic_sort_cols,
                                         bitonic_sort_cols_reference,
                                         sort_by_bucket_reference)
from rtts_torch.ops.row_gather import row_gather, row_gather_reference
from rtts_torch.text import frontend_vocab_size
from rtts_torch.train.optim import make_optimizer
from rtts_torch.train.train_tts import make_train_step

# the least time of a function on an H100 SXM at 700 W: bytes over the HBM
# rate; K7's compare-exchanges (an integer min and max each) at the f32
# rate outside the tensor cores, the nearest row of the card's table
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# LSH shapes: (b, h, n_hashes, L) at chunk 64; the keys have b h nh columns
SHAPES = {
    "probe L4096 C128": (4, 8, 4, 4096),
    "longform b2 h8 nh4 L8192": (2, 8, 4, 8192),
    "serving_fast b8 h8 nh4 L1024": (8, 8, 4, 1024),
}
CHUNK, HEAD_DIM = 64, 64
# gathers: (rows per slice, width, dtype, the LSH shape or None for one
# permutation of the probe's own rows)
GATHERS = {
    "probe L4096 d128 f32": (4096, 128, torch.float32, None),
    "probe L4096 d256 f32": (4096, 256, torch.float32, None),
    "longform (16, 32768, 128) bf16": (8192, 2 * HEAD_DIM, torch.bfloat16,
                                       "longform b2 h8 nh4 L8192"),
    "serving_fast (64, 4096, 128) bf16": (1024, 2 * HEAD_DIM, torch.bfloat16,
                                          "serving_fast b8 h8 nh4 L1024"),
}

# the train steps of the verdict: the model sections of
# configs/longform_8k.yaml and configs/serving_fast.yaml (the tests hold
# them equal to the files), and the (batch, tokens, frames) of a step
_LSH = {"kind": "lsh", "num_heads": 8, "head_dim": 64, "num_hashes": 4,
        "chunk_length": 64}


def _stacks(attention, **stack):
    return {"encoder": dict(stack, causal=False, attention=dict(attention)),
            "decoder": dict(stack, causal=True, attention=dict(attention))}


STEP_MODELS = {
    "longform_8k": ({
        "d_model": 512, "n_mels": 80, "max_pos": 8192,
        **_stacks(dict(_LSH, num_chunks_before=1), num_layers=6, d_model=512,
                  d_ff=2048, ffn_chunk_size="auto", reversible="auto",
                  auto_plain_budget_mb=12288),
        "compute_dtype": "bfloat16"}, (2, 1024, 8192)),
    "serving_fast": ({
        "d_model": 512, "n_mels": 80,
        **_stacks(_LSH, num_layers=6, d_model=512, d_ff=2048,
                  ffn_chunk_size=256, reversible=True),
        "compute_dtype": "bfloat16", "kv_cache_dtype": "float8_e4m3fn"},
        (8, 256, 1024)),
}
SORT_GATHER_OPS = ("aten::sort", "aten::argsort", "aten::gather")
# K7's path entry, launched through ctypes (no aten op holds it): by the
# name of its kernels
K7_PATH_KERNEL = "BucketIO"
# a fused sort + attend is a large kernel to write and keep; below this
# share of the step's device time it cannot pay for itself
PAYS_MIN_SHARE = 0.05


# ------------------------------------------------------------------ checks --


def check(device: str = "cuda") -> None:
    """The original's cases, exact against numpy: two column sorts and one
    permuted row gather, through the wrappers (kernels on the card, plain
    versions on the CPU)."""
    dev = _device(device)
    rng = np.random.default_rng(0)
    for n, c in ((64, 8), (256, 128)):
        x = rng.integers(0, 1 << 20, (n, c), dtype=np.int32)
        got = bitonic_sort_cols(torch.from_numpy(x).to(dev))
        np.testing.assert_array_equal(got.cpu().numpy(), np.sort(x, axis=0))
    x = rng.standard_normal((128, 128)).astype(np.float32)
    idx = rng.permutation(128).astype(np.int32)
    got = row_gather(torch.from_numpy(x).to(dev), torch.from_numpy(idx).to(dev))
    np.testing.assert_array_equal(got.cpu().numpy(), x[idx])
    what = "the kernels" if dev.type == "cuda" else "the plain versions"
    print(f"checks OK on {dev.type} ({what})", flush=True)


def _device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_vmem_sort: no CUDA device (only --check "
                           "--device cpu runs without one)")
    return dev


# ------------------------------------------------------------------- bench --


def _events_ms(fn, iters: int) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _time_all(fns: dict, iters: int) -> dict:
    """ms per call of each function: two warm-up calls each, then timed in
    order and in reverse order; the mean of the two."""
    for fn in fns.values():
        fn(), fn()
    torch.cuda.synchronize()
    ms = {name: 0.0 for name in fns}
    for order in (list(fns), list(reversed(fns))):
        for name in order:
            ms[name] += _events_ms(fns[name], iters) / 2
    return ms


def lsh_buckets(b, h, nh, l, seed=0, device="cuda"):
    """Random buckets (b, h, nh, L) int64 in [0, nb) (nb the auto count at
    chunk 64) and their packed keys bucket * L + pos as K7 sorts them:
    (L, b h nh) int32, a column per (batch, head, round)."""
    g = torch.Generator().manual_seed(seed)
    nb = TL.auto_num_buckets(l, CHUNK)
    buckets = torch.randint(0, nb, (b, h, nh, l), generator=g)
    keys = (buckets * l + torch.arange(l)).reshape(-1, l).t().contiguous()
    return buckets.to(device), keys.int().to(device)


def sort_bound(n: int, cols: int) -> dict:
    """Bytes and operations of sorting (n, cols) int32 keys: each read and
    written once; n/2 compare-exchanges per pass and column, two
    operations each."""
    log_n = n.bit_length() - 1
    passes = log_n * (log_n + 1) // 2
    return {"bytes": 2 * 4 * n * cols, "ops": 2 * passes * (n // 2) * cols,
            "compare_exchanges": passes * (n // 2) * cols}


def _bound_ms(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / SCALAR_OPS_PER_S) * 1e3


def bench_sort(name: str, iters: int = 20) -> dict:
    b, h, nh, l = SHAPES[name]
    buckets, keys = lsh_buckets(b, h, nh, l)
    want = torch.sort(keys, dim=0).values
    if not torch.equal(bitonic_sort_cols(keys), want):
        raise RuntimeError(f"K7 disagrees with torch.sort at {name}")
    ms = _time_all({
        "K7": lambda: bitonic_sort_cols(keys),
        "plain": lambda: bitonic_sort_cols_reference(keys),
        "torch.sort": lambda: torch.sort(keys, dim=0).values,
        "argsort+take": lambda: torch.take_along_dim(
            keys, torch.argsort(keys, dim=0), dim=0),
        "_sort_by_bucket": lambda: TL._sort_by_bucket(buckets),
        "sort_by_bucket_reference": lambda: sort_by_bucket_reference(buckets),
    }, iters)
    work = sort_bound(*keys.shape)
    bound = _bound_ms(work["bytes"], work["ops"])
    print(f"A. sort {name} ({keys.shape[0]} x {keys.shape[1]} int32 keys, "
          f"{work['compare_exchanges']} compare-exchanges): K7 "
          f"{ms['K7']:.4f} ms | plain {ms['plain']:.4f} ms | torch.sort "
          f"{ms['torch.sort']:.4f} ms | argsort+take "
          f"{ms['argsort+take']:.4f} ms | _sort_by_bucket (K7's path entry "
          f"on {tuple(buckets.shape)}) {ms['_sort_by_bucket']:.4f} ms | "
          f"sort_by_bucket_reference (sort + argsort) "
          f"{ms['sort_by_bucket_reference']:.4f} ms | bound "
          f"{bound:.4f} ms (bytes)", flush=True)
    return dict(ms, bound_ms=bound, **work)


def _gather_inputs(name: str, seed: int = 2):
    """(x (slices, L, W), per-round permutations idx (slices, nh, L) int64
    and their inverses, the flat row index K8 takes)."""
    l, w, dtype, shape = GATHERS[name]
    g = torch.Generator().manual_seed(seed)
    if shape is None:
        slices = 1
        idx = torch.randperm(l, generator=g).reshape(1, 1, l).cuda()
    else:
        b, h, nh, _ = SHAPES[shape]
        slices = b * h
        buckets, _ = lsh_buckets(b, h, nh, l, seed)
        idx = TL._sort_by_bucket(buckets)[0].reshape(slices, nh, l)
    x = torch.randn(slices, l, w, generator=g).to("cuda", dtype)
    inv = torch.argsort(idx, dim=-1)
    offset = torch.arange(slices, device="cuda")[:, None, None] * l
    flat = (idx + offset).reshape(-1).int()
    return x, idx, inv, flat


def gather_bound(x: torch.Tensor, flat: torch.Tensor) -> dict:
    """Bytes of the gather with these indices: the rows it reads once, the
    indices, the output."""
    row = x.shape[-1] * x.element_size()
    rows_read = torch.unique(flat).numel()
    return {"bytes": rows_read * row + flat.numel() * (4 + row), "ops": 0}


def bench_gather(name: str, iters: int = 20) -> dict:
    x, idx, inv, flat = _gather_inputs(name)
    slices, l, w = x.shape
    x2 = x.reshape(slices * l, w)
    want = x2[flat.long()]
    if not torch.equal(row_gather(x2, flat), want):
        raise RuntimeError(f"K8 disagrees with indexing at {name}")
    sel = idx.reshape(slices, -1)

    def onehot():
        oh = (sel[..., None] == torch.arange(l, device="cuda")).to(
            torch.bfloat16)
        return torch.einsum("bsl,blw->bsw", oh, x.to(torch.bfloat16))

    if not torch.equal(onehot().reshape(-1, w), want.to(torch.bfloat16)):
        raise RuntimeError(f"the one-hot gather is not exact at {name}")
    ms = _time_all({
        "K8": lambda: row_gather(x2, flat),
        "plain": lambda: row_gather_reference(x2, flat),
        "one-hot bf16": onehot,
        "index_select": lambda: torch.index_select(x2, 0, flat),
        "_perm_rows_take": lambda: TL._perm_rows_take(x, idx, inv),
    }, iters)
    work = gather_bound(x2, flat)
    bound = _bound_ms(work["bytes"], 0)
    rows = flat.numel()
    print(f"B. row gather {name} ({rows} rows of {w} {str(x.dtype)[6:]}): K8 "
          f"{ms['K8']:.4f} ms ({rows / ms['K8'] / 1e3:.1f} Mrows/s) | plain "
          f"{ms['plain']:.4f} ms | one-hot bf16 matmul "
          f"{ms['one-hot bf16']:.4f} ms | index_select "
          f"{ms['index_select']:.4f} ms | _perm_rows_take "
          f"{ms['_perm_rows_take']:.4f} ms | bound {bound:.4f} ms (bytes)",
          flush=True)
    return dict(ms, bound_ms=bound, rows=rows, **work)


def bench_modes(name: str, iters: int = 5) -> dict:
    """``lsh_attention_core`` forward + backward, bf16, causal, with fixed
    buckets, in the two sort_gather modes (the chunk attend is K4/K5)."""
    b, h, nh, l = SHAPES[name]
    g = torch.Generator().manual_seed(3)
    qk, v, cot = (torch.randn(b, h, l, HEAD_DIM, generator=g).to(
        "cuda", torch.bfloat16) for _ in range(3))
    buckets, _ = lsh_buckets(b, h, nh, l)
    base = AttentionConfig(kind="lsh", num_heads=h, head_dim=HEAD_DIM,
                           num_hashes=nh, chunk_length=CHUNK)

    def step(mode):
        cfg = dataclasses.replace(base, sort_gather=mode)

        def run():
            q, vv = (t.detach().requires_grad_() for t in (qk, v))
            out, _ = TL.lsh_attention_core(q, vv, cfg, None, True, None,
                                           buckets=buckets)
            out.backward(cot)
        return run

    torch.cuda.reset_peak_memory_stats()
    ms = _time_all({"onehot": step("onehot"), "take": step("take")}, iters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"C. lsh_attention_core {name} bf16 causal, forward + backward: "
          f"sort_gather onehot {ms['onehot']:.4f} ms | take "
          f"{ms['take']:.4f} ms (peak device memory of both {peak:.2f} GiB)",
          flush=True)
    return ms


def _train_step(name: str):
    """A seeded model of STEP_MODELS[name], its optimizer state and a step
    function on a batch with every position valid."""
    model_cfg, (b, n_tok, frames) = STEP_MODELS[name]
    data = copy.deepcopy(model_cfg)
    data["vocab_size"] = frontend_vocab_size("char")
    cfg = from_dict(Config, {"model": data})
    model = M.init(cfg.model, torch.Generator().manual_seed(0), "cuda")
    optimizer = make_optimizer(cfg.experiment.optim)
    state = optimizer.init(list(model.parameters()))
    step_fn = make_train_step(cfg.model, optimizer)
    g = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(3, cfg.model.vocab_size, (b, n_tok),
                                     generator=g),
             "token_mask": torch.ones(b, n_tok, dtype=torch.bool),
             "mel": 0.5 * torch.randn(b, frames, cfg.model.n_mels, generator=g),
             "mel_mask": torch.ones(b, frames, dtype=torch.bool)}
    batch = {k: t.cuda() for k, t in batch.items()}
    gen = torch.Generator(device="cuda")

    def step():
        step_fn(model, state, batch, gen.manual_seed(0), state["count"])
        torch.cuda.synchronize()
    return step


def sort_gather_share(events, busy_us: float, k7_us: float = 0.0) -> dict:
    """Device time (us) of each of SORT_GATHER_OPS in a profile's function
    events, counting an op only where no other of them encloses it (argsort
    calls sort), with ``k7_us`` of K7's path entry, and its share of
    ``busy_us``."""
    def enclosed(e):
        p = e.cpu_parent
        while p is not None:
            if p.name in SORT_GATHER_OPS:
                return True
            p = p.cpu_parent
        return False

    by_op = {name: 0.0 for name in SORT_GATHER_OPS}
    for e in events:
        if e.name in SORT_GATHER_OPS and not enclosed(e):
            by_op[e.name] += e.device_time_total
    by_op["K7 sort_by_bucket"] = k7_us
    total = sum(by_op.values())
    return {"by_op_us": by_op, "us": total, "busy_us": busy_us,
            "share": total / busy_us if busy_us else float("nan")}


def step_share(name: str) -> dict:
    """One warmed-up train step of STEP_MODELS[name] under torch.profiler:
    the device time of sort, argsort and gather against all of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = _train_step(name)
    step()   # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device)
    if busy <= 0:
        raise RuntimeError("probe_vmem_sort: the profiler saw no device work")
    k7 = sum(e.self_device_time_total for e in device
             if K7_PATH_KERNEL in e.key)
    share = sort_gather_share(prof.events(), busy, k7)
    b, n_tok, frames = STEP_MODELS[name][1]
    print(f"D. {name} train step b{b} x {n_tok} tokens x {frames} frames "
          f"bf16: device busy {busy / 1e3:.3f} ms; sort/argsort/gather/K7 "
          f"{share['us'] / 1e3:.3f} ms = {share['share']:.2%} ("
          + ", ".join(f"{k} {v / 1e3:.3f} ms"
                      for k, v in share["by_op_us"].items()) + ")",
          flush=True)
    del step
    torch.cuda.empty_cache()
    return share


def bench() -> dict:
    """Parts A-C and the step shares on the card; prints the verdict and
    returns every number by part and shape."""
    _device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    result = {"sort": {name: bench_sort(name) for name in SHAPES},
              "gather": {name: bench_gather(name, 5 if "longform" in name
                                            else 20) for name in GATHERS},
              "modes": {name: bench_modes(name) for name in SHAPES
                        if not name.startswith("probe")},
              "share": {name: step_share(name) for name in STEP_MODELS}}
    result["verdict"] = verdict(result)
    return result


def verdict(result: dict) -> dict:
    """A fused sort + attend saves at most the sort + gather share of a
    step, and only where both primitives beat the LSH path's torch ops (the
    sort's: ``sort_by_bucket_reference``, since the path's own sort is K7's
    path entry)."""
    lf_sort = result["sort"]["longform b2 h8 nh4 L8192"]
    lf_gather = result["gather"]["longform (16, 32768, 128) bf16"]
    k7_gain = lf_sort["sort_by_bucket_reference"] / lf_sort["K7"]
    k8_gain = lf_gather["_perm_rows_take"] / lf_gather["K8"]
    shares = {name: s["share"] for name, s in result["share"].items()}
    pays = (max(shares.values()) >= PAYS_MIN_SHARE and k7_gain > 1
            and k8_gain > 1)
    print(f"verdict (H100): sort/argsort/gather/K7 take "
          + ", ".join(f"{v:.2%} of the {k} step" for k, v in shares.items())
          + f"'s device time; at the longform shape the torch sort takes "
          f"{k7_gain:.2f}x K7's time and the path's gather {k8_gain:.2f}x "
          f"K8's; a fused sort + attend {'would' if pays else 'would not'} "
          f"pay (it needs a share of at least {PAYS_MIN_SHARE:.0%} and both "
          f"primitives faster than the torch ops)", flush=True)
    return {"shares": shares, "k7_gain": k7_gain, "k8_gain": k8_gain,
            "pays": pays}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="correctness of K7 and K8 (or their plain versions)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.check:
        check(args.device)
    elif args.device != "cuda":
        ap.error("the bench times the card: --device cpu takes --check")
    else:
        bench()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
