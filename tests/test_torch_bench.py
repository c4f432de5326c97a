"""The port's benchmark harness (``rtts_torch/bench.py``) against the JAX
package's (``rtts/bench.py``) on the CPU.

(a) The three bench configs equal the JAX package's, field for field.
(b) Each cell's CPU path at a tiny config (``device="cpu"``, one repeat,
    small lengths, counts and batches) prints one JSON line whose metric
    name, line keys and ``detail`` keys are ``rtts/bench.py``'s, read from
    its source: apart from the renames of the kernels cell (``xla_ms`` ->
    ``plain_ms``, ``pallas_ms`` -> ``kernel_ms``,
    ``pallas_vs_xla_min_speedup`` -> ``cuda_vs_plain_min_speedup``), the
    port adds only the keys its docstring names: ``device`` where the
    reference had none, ``power_limit_w``, ``resolved``, each wall's
    ``*_band`` and the kernels' ``max_err`` and ``max_abs_err``.
(c) ``run_bench``'s ``value`` and ``vs_baseline`` equal the JAX
    package's on the same fixed cell results (both harnesses' cells
    stubbed).
(d) The analytic FLOPs of the encode (full, LSH and local attention), one
    decode step in every cache mode (kv_full at two cache lengths), the
    postnet and the vocoder's ``infer`` equal ``FlopCounterMode`` over the
    port's plain CPU path at tiny f32 configs (matmul, bmm and convolution
    FLOPs; the kernels' plain versions called directly, since the counter
    does not look inside the ``rtts::`` operators).
(e) ``_decode_flops`` against the JAX ``_decode_flops`` (XLA's cost
    analysis) at one tiny staged config, within a stated band.
(f) ``_mfu`` is None without a peak or a count; the peak is the H100's
    only; a cell asked for the card on a host without one raises.
"""

import ast
import dataclasses
import io
import json
import math
import pathlib
import contextlib

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from rtts import bench as JB
from rtts import config as JC
from rtts.models import reformer_tts as JM
from rtts_torch import bench as B
from rtts_torch import cli as TCLI
from rtts_torch.config import load_config, to_dict
from rtts_torch.infer import decode as D
from rtts_torch.models import reformer_tts as M
from rtts_torch.models import squeezewave as SW
from rtts_torch.ops import depthwise_conv as DW
from rtts_torch.text import frontend_vocab_size
from torch_twin import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = str(ROOT / "configs" / "tiny.yaml")
REFERENCE = ROOT / "rtts" / "bench.py"


# -- (a) configs -------------------------------------------------------------


@pytest.mark.parametrize("name", ["base_bench_config", "flagship_bench_config",
                                  "longform_bench_config"])
def test_bench_configs_equal_the_jax_packages(name):
    got, want = getattr(B, name)(), getattr(JB, name)()
    assert got.model.vocab_size == want.model.vocab_size > 0
    assert to_dict(got) == JC.to_dict(want)


def test_flagship_resolves_as_its_docstring_says():
    """base.yaml at the bench's shapes: full attention, plain residuals,
    an unchunked FFN and the kv_full cache; base_bench_config keeps its
    reversible LSH encoder."""
    flag = B._resolved(B.flagship_bench_config(), 8, 256, 512, "auto")
    for stack in ("encoder", "decoder"):
        assert flag[stack]["attention"] == ["full"] * 6
        assert flag[stack]["reversible"] is False
        assert flag[stack]["ffn_chunk"] == 0
    assert flag["decode_mode"] == "kv_full"
    base = B._resolved(B.base_bench_config(), 8, 256, 512, "auto")
    assert base["encoder"]["attention"] == ["lsh"] * 4
    assert base["encoder"]["reversible"] and base["decoder"]["reversible"]
    long = B._resolved(B.longform_bench_config(), 2, 1024, 8192, "auto")
    assert long["decode_mode"] == "kv_lsh_chunk"


# -- (b) each cell's CPU path and its keys -----------------------------------

SMALL = {
    "decode": dict(batch=2, token_len=16, max_frames=16),
    "e2e": dict(batch=2, token_len=16, max_frames=16),
    "vocoder": dict(batch=1, mel_frames=8),
    "train": dict(batch=2, token_len=16, mel_len=32),
    "vocoder_train": dict(batch=1),
    "longform": dict(batch=1, token_len=128, max_frames=16),
    "serving": dict(per_bucket=1, lengths=(16, 32), token_lens=(16, 16)),
    "continuous": dict(per_group=1, lengths=(16, 32), slots=2,
                       segment_frames=16, token_len=16),
    "latency": dict(concurrency=(1, 2), lengths=(16, 32), token_len=16,
                    max_frames=64, chunk_sweep=(64,)),
    "kernels": dict(shapes={"lsh": (1, 2, 2, 64, 16, 64),
                            "ffn": (1, 16, 32, 64),
                            "depthwise": (1, 32, 8, 3),
                            "flash": (1, 32, 128, 2)}),
}
# the reference's cell functions behind each mode
CELLS = {"decode": ["bench_decode"], "e2e": ["bench_e2e"],
         "vocoder": ["bench_vocoder"], "train": ["bench_train_step"],
         "vocoder_train": ["bench_vocoder_train"],
         "longform": ["bench_decode", "bench_longform"],
         "serving": ["bench_serving"], "continuous": ["bench_continuous"],
         "latency": ["bench_latency"], "kernels": ["bench_kernels"]}
RENAMED = {"xla_ms": "plain_ms", "pallas_ms": "kernel_ms",
           "pallas_vs_xla_min_speedup": "cuda_vs_plain_min_speedup"}
ADDED = {"device", "power_limit_w", "resolved", "max_err", "max_abs_err"}


def _kernel_tol() -> dict:
    """chip_smoke.py's tolerance of each kernels entry, by the dtype its
    kernel reads: max |got - want| / max(|want|, 1)."""
    import chip_smoke

    return {name: chip_smoke.KERNEL_TOL[dtype]
            for name, dtype in chip_smoke.BENCH_KERNEL_DTYPES.items()}


def _reference_functions() -> dict:
    tree = ast.parse(REFERENCE.read_text())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _literal_keys(fn: ast.FunctionDef) -> set:
    """The string keys of the result dicts that ``fn`` builds: dict
    displays returned, assigned to a subscript or to a name the return
    names, and assignments to a subscript by a string constant (not, say,
    an input batch's keys)."""
    returned = {n.id for r in ast.walk(fn) if isinstance(r, ast.Return)
                and r.value is not None for n in ast.walk(r.value)
                if isinstance(n, ast.Name)}
    dicts, keys = [], set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            dicts.append(node.value)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) or (
                        isinstance(t, ast.Name) and t.id in returned):
                    if isinstance(node.value, ast.Dict):
                        dicts.append(node.value)
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.slice, ast.Constant)
                        and isinstance(t.slice.value, str)):
                    keys.add(t.slice.value)
    for d in dicts:
        for sub in ast.walk(d):
            if isinstance(sub, ast.Dict):
                keys |= {k.value for k in sub.keys
                         if isinstance(k, ast.Constant)
                         and isinstance(k.value, str)}
    return keys


def _reference_lines() -> dict:
    """mode -> (the line dict's keys, its metric name) in ``run_bench``."""
    out = {}
    for node in ast.walk(_reference_functions()["run_bench"]):
        if (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
                and isinstance(node.test.comparators[0], ast.Constant)):
            mode = node.test.comparators[0].value
            for sub in node.body:
                for d in ast.walk(sub):
                    if isinstance(d, ast.Dict) and any(
                            isinstance(k, ast.Constant) and k.value == "metric"
                            for k in d.keys):
                        keys = [k.value for k in d.keys]
                        metric = d.values[keys.index("metric")].value
                        out[mode] = (set(keys), metric)
    return out


def _detail_keys(detail: dict) -> set:
    """Every key of ``detail``'s nested dicts, ``resolved`` not entered,
    labels made of digits (lengths, concurrency, chunk sizes) left out."""
    keys = set()
    for k, v in detail.items():
        if not k.isdigit():
            keys.add(k)
        if isinstance(v, dict) and k != "resolved":
            keys |= _detail_keys(v)
    return keys


def _finite_positive(x) -> bool:
    return isinstance(x, float) and math.isfinite(x) and x > 0


@pytest.mark.parametrize("mode", B.MODES)
def test_cell_prints_the_reference_line(mode):
    line = json.loads(B.run_bench(load_config(TINY), mode, device="cpu",
                                  repeats=1, **SMALL[mode]))
    line_keys, metric = _reference_lines()[mode]
    assert set(line) == line_keys
    assert line["metric"] == RENAMED.get(metric, metric)
    assert _finite_positive(line["value"]) and _finite_positive(
        line["vs_baseline"])
    ref = _reference_functions()
    want = set().union(*(_literal_keys(ref[f]) for f in CELLS[mode]))
    if mode == "longform":
        want.add("config_note")           # run_bench's own addition
    want = {RENAMED.get(k, k) for k in want} - ADDED
    got = _detail_keys(line["detail"])
    extra = {k for k in got - want if k in ADDED or k.endswith("_band")}
    assert got - extra == want, (got - extra) ^ want
    detail = line["detail"]
    assert detail["device"] == "cpu" and detail["power_limit_w"] is None
    if "mfu" in detail:                   # no peak on the CPU
        assert detail["mfu"] is None and _finite_positive(detail["flops"])
    if mode == "kernels":                 # each kernel against its plain one
        entries = {k: v for k, v in detail.items() if isinstance(v, dict)}
        tol = _kernel_tol()
        assert set(entries) == set(tol)
        assert all(e["max_err"] <= tol[k]
                   for k, e in entries.items()), entries


# -- (c) run_bench's formulas ---------------------------------------------------

FIXED = {
    "decode": ("bench_decode", {"frames_per_sec": 1234.5}),
    "e2e": ("bench_e2e", {"rtf": 0.0731}),
    "vocoder": ("bench_vocoder", {"vocoder_rtf": 0.0123}),
    "longform": ("bench_longform", {"frames_per_sec": 150.25, "rtf": 0.41}),
    "train": ("bench_train_step", {"frames_per_sec_train": 40123.5}),
    "vocoder_train": ("bench_vocoder_train", {"train_rtf": 0.2}),
    "serving": ("bench_serving", {"speedup": 1.3}),
    "continuous": ("bench_continuous",
                   {"fused_speedup_vs_sync_arrival": 2.1}),
    "latency": ("bench_latency", {"streaming_ttfa": {
        "32": {"ttfa_s": 0.1, "first_chunk_audio_s": 0.37},
        "64": {"ttfa_s": 0.2, "first_chunk_audio_s": 0.74}}}),
    "kernels": ("bench_kernels", {"device": "x", "a": {"speedup": 1.5},
                                  "b": {"speedup": 0.8}}),
}


@pytest.mark.parametrize("mode", B.MODES)
def test_vs_baseline_equals_the_jax_formula(mode, monkeypatch):
    name, result = FIXED[mode]
    for module in (B, JB):
        monkeypatch.setattr(module, name,
                            lambda *a, **k: json.loads(json.dumps(result)))
    cfg = load_config(TINY, [f"model.vocab_size={frontend_vocab_size()}"])
    got = json.loads(B.run_bench(cfg, mode, device="cpu"))
    want = json.loads(JB.run_bench(JC.from_dict(JC.Config, to_dict(cfg)),
                                   mode))
    want["metric"] = RENAMED.get(want["metric"], want["metric"])
    assert got == want


# -- (d) FLOPs against FlopCounterMode over the plain path ----------------------


def _flops(fn) -> int:
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _tiny(*overrides):
    return load_config(TINY, [f"model.vocab_size={frontend_vocab_size()}",
                              "model.encoder.attention.flash=false",
                              "model.decoder.attention.flash=false",
                              *overrides])


def _model(cfg):
    return M.init(cfg.model, torch.Generator().manual_seed(0), "cpu")


def _memory(cfg, model, b, l):
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(3, 40, (b, l), generator=g)
    mask = torch.ones((b, l), dtype=torch.bool)
    return tok, mask, M.encode(model, cfg.model, tok, mask)


ENCODERS = {
    "full": (),
    "lsh": ("model.encoder.attention.kind=lsh",
            "model.encoder.attention.chunk_length=16",
            "model.encoder.attention.num_hashes=2",
            "model.encoder.attention.use_pallas=false"),
    "local": ("model.encoder.attention.kind=local",
              "model.encoder.attention.chunk_length=16",
              "model.encoder.attention.use_pallas=false"),
}


@pytest.mark.parametrize("kind", list(ENCODERS))
def test_encode_flops_equal_the_flop_counter(kind):
    """40 tokens: LSH and local pad them to 48 (3 chunks of 16)."""
    cfg = _tiny(*ENCODERS[kind])
    model = _model(cfg)
    tok = torch.randint(3, 40, (2, 40), generator=torch.Generator()
                        .manual_seed(1))
    mask = torch.ones((2, 40), dtype=torch.bool)
    got = _flops(lambda: M.encode(model, cfg.model, tok, mask))
    assert B._encode_flops(cfg.model, 2, 40) == got


STEPS = {   # (decoder kind, mode, cache length, groups)
    "kv_full_16": ("full", "kv_full", 16, 48),
    "kv_full_48": ("full", "kv_full", 48, 48),
    "kv_lsh": ("lsh", "kv_lsh", 64, 64),
    "kv_lsh_chunk": ("lsh", "kv_lsh_chunk", 32, 64),
    "kv_local": ("local", "kv_local", 64, 64),
}


@pytest.mark.parametrize("case", list(STEPS))
def test_decode_step_flops_equal_the_flop_counter(case):
    """One ``_Decoder.step`` with caches of the given length: the
    attention terms grow with it (kv_full, kv_lsh) or stay at the ring's
    (kv_lsh_chunk) and window's (kv_local)."""
    kind, mode, cache, groups = STEPS[case]
    cfg = _tiny(f"model.decoder.attention.kind={kind}",
                "model.decoder.attention.chunk_length=8",
                "model.decoder.attention.num_hashes=2")
    model = _model(cfg)
    _, mask, memory = _memory(cfg, model, 2, 12)
    rotations, nb = None, 0
    if mode in ("kv_lsh", "kv_lsh_chunk"):
        rotations, nb = D._decode_rotations(cfg.model, None, groups, "cpu")
    spec = D._local_spec(cfg.model, groups) if mode == "kv_local" else None
    dec = D._Decoder(model, cfg.model, memory, mask, groups, cache, mode,
                     None, 2.0, rotations, nb, spec)
    got = _flops(lambda: dec.step(3))
    assert B._step_flops(cfg.model, 2, 12, cache, mode, groups) == got


def test_postnet_and_vocoder_flops_equal_the_flop_counter(monkeypatch):
    cfg = _tiny()
    model = _model(cfg)
    mel = torch.randn(2, 32, cfg.model.n_mels)
    got = _flops(lambda: M.postnet_apply(model.postnet, mel, torch.float32))
    assert B._postnet_flops(cfg.model, 2, 32) == got
    voc = SW.fold_weightnorm(SW.init(cfg.vocoder,
                                     torch.Generator().manual_seed(2), "cpu"))
    # the depthwise stage's plain version, so that the counter sees its conv
    monkeypatch.setattr(SW, "depthwise_conv1d", DW.depthwise_conv1d_reference)
    got = _flops(lambda: SW.infer(voc, cfg.vocoder,
                                  torch.randn(2, 8, cfg.vocoder.n_mels)))
    assert B._vocoder_flops(cfg.vocoder, 2, 8) == got


# -- (e) against the JAX package's cost analysis ---------------------------------

# XLA's cost analysis also counts elementwise work (softmax, layer norms,
# activations, the residual adds), which the port's count leaves out; the
# port adds the cross-attention K/V of the memory, which the reference's
# per-piece compiles close over and so do not count.  At this config the
# port's count is 0.967 of XLA's; the band allows each side 5-10%.
JAX_BAND = (0.90, 1.05)


def test_decode_flops_within_a_band_of_the_jax_cost_analysis():
    """tiny.yaml, b2 x 16 tokens x 128 frames, staged from 32 groups (three
    stages: 32, 64, 128)."""
    cfg = load_config(TINY, [f"model.vocab_size={frontend_vocab_size()}"])
    jcfg = JC.from_dict(JC.Config, to_dict(cfg))
    params = JM.init(jax.random.PRNGKey(0), jcfg.model)
    want = JB._decode_flops(jcfg, params, 2, 16, 128, "kv_full", staged=True,
                            stage_min=32)
    got = B._decode_flops(cfg, 2, 16, 128, "kv_full", staged=True,
                          stage_min=32)
    assert JAX_BAND[0] <= got / want <= JAX_BAND[1], got / want


# -- (f) MFU, the peak and the device ----------------------------------------------


def test_mfu_needs_a_peak_and_a_count(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert B._mfu(1e12, 1.0, cpu) is None               # no peak on the CPU
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert B._device_peak_flops(cuda) == 989e12
    assert B._mfu(None, 1.0, cuda) is None              # no count
    assert B._mfu(989e12, 0.0, cuda) is None
    assert B._mfu(989e12 / 2, 1.0, cuda) == 0.5
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA A100-SXM4-80GB")
    assert B._device_peak_flops(cuda) is None
    assert B._mfu(1e12, 1.0, cuda) is None


@pytest.mark.parametrize("mode", B.MODES)
def test_cell_on_cuda_without_a_card_raises(mode, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        B.run_bench(load_config(TINY), mode)


def test_entry_point_prints_one_line_per_mode(monkeypatch):
    """``python -m rtts_torch.bench`` on the CPU, and the command line's
    modes are the bench's; without a card the default device raises."""
    assert list(B.MODES) + ["all"] == TCLI.BENCH_MODES
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert B.main(["--config", TINY, "--which", "vocoder_train",
                       "--device", "cpu"]) == 0
    (line,) = out.getvalue().splitlines()
    got = json.loads(line)
    assert got["metric"] == "vocoder_train_rtf" and got["value"] > 0
    assert got["detail"]["device"] == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        B.main(["--config", TINY, "--which", "vocoder"])
