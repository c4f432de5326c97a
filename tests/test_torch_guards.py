"""Guards around the rtts_torch port.

(a) The port imports neither JAX nor the JAX package ``rtts``: subprocesses
    that make ``import jax`` and ``import rtts`` fail import every module of
    ``rtts_torch``, synthesize speech (also through ``serve_continuous``
    and ``StreamingSynthesizer``) and take train steps (full and LSH
    attention, and the vocoder's) with a tiny model; and by their import statements, no module
    of the port and not ``chip_smoke.py`` names ``jax``, ``rtts``,
    ``click`` or ``yaml``; the sort probe runs its CPU check with both
    blocked; the command line answers ``--help`` and a config file loads
    with ``jax``, ``rtts``, ``click`` and ``yaml`` all blocked.
(b) ``chip_smoke.py``'s configs (dicts, so the card's machine needs no
    PyYAML) equal ``configs/base.yaml``, ``configs/longform_8k.yaml``,
    ``configs/serving_fast.yaml`` and ``configs/parity_local.yaml``.
(c) The decoder prenet's always-on dropout zeroes about ``rate`` of the
    units, scales the rest by 1/keep, and follows its generator.
(d) The ctypes signatures the port loads its kernels with
    (``rtts_torch.ops._build.SIGNATURES``) match the C entry points'
    prototypes in ``rtts_torch/csrc``, argument by argument.
"""

import ast
import ctypes
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtts.config import load_yaml
from rtts_torch.nn.layers import PrenetMLP, dropout
from rtts_torch.ops._build import SIGNATURES
from torch_twin import one_thread  # noqa: F401  (autouse)


ROOT = pathlib.Path(__file__).resolve().parent.parent

NO_JAX_SLICE = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["rtts"] = None         # and so does any `import rtts...`
import numpy as np
import torch
from rtts_torch.config import Config, from_dict
from rtts_torch.infer.synthesize import Synthesizer
from rtts_torch.models import reformer_tts as M, squeezewave as SW
from rtts_torch.text import frontend_vocab_size

att = {"kind": "auto", "num_heads": 2, "head_dim": 16}
stack = {"num_layers": 1, "d_model": 32, "d_ff": 64, "attention": att}
cfg = from_dict(Config, {
    "model": {"vocab_size": frontend_vocab_size(), "d_model": 32,
              "n_mels": 20, "encoder": dict(stack, causal=False),
              "decoder": dict(stack, causal=True), "dec_prenet_hidden": 16,
              "postnet_channels": 16, "max_pos": 64},
    "vocoder": {"n_mels": 20, "n_flows": 2, "n_group": 32,
                "n_early_every": 4, "n_early_size": 8, "wn_layers": 2,
                "wn_channels": 16, "hop_length": 64}})
g = torch.Generator().manual_seed(0)
syn = Synthesizer(cfg, M.init(cfg.model, g, "cpu"), SW.init(cfg.vocoder, g, "cpu"),
                  max_frames=16)
wavs = syn(["hello world", "the port imports no jax"])
assert [w.ndim for w in wavs] == [1, 1]
assert all(len(w) > 0 and np.isfinite(w).all() for w in wavs)
wavs += syn.serve_continuous(["serving", "without jax"], min_frames=16,
                             slots=2, segment_frames=8)
from rtts_torch.infer.streaming import StreamingSynthesizer
chunks = list(StreamingSynthesizer(cfg, syn.tts, syn.vocoder, max_frames=16)
              .stream(["streaming"], chunk_frames=8))
wavs.append(np.concatenate(chunks, axis=1)[0])
assert all(len(w) > 0 and np.isfinite(w).all() for w in wavs)
assert not any(m.split(".")[0] in ("jax", "rtts") for m in sys.modules
               if sys.modules[m] is not None)
print("OK", [len(w) for w in wavs])
"""


NO_JAX_TRAIN = r"""
import importlib
import pkgutil
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["rtts"] = None         # and so does any `import rtts...`
import torch
import rtts_torch
for info in pkgutil.walk_packages(rtts_torch.__path__, "rtts_torch."):
    importlib.import_module(info.name)
from rtts_torch.config import Config, from_dict
from rtts_torch.models import reformer_tts as M
from rtts_torch.text import frontend_vocab_size
from rtts_torch.train.optim import make_optimizer
from rtts_torch.train.train_tts import make_train_step, step_generator

att = {"kind": "auto", "num_heads": 2, "head_dim": 16,
       "attention_dropout": 0.1}
stack = {"num_layers": 1, "d_model": 32, "d_ff": 64, "attention": att,
         "dropout": 0.1, "reversible": "auto", "ffn_chunk_size": "auto"}
cfg = from_dict(Config, {
    "model": {"vocab_size": frontend_vocab_size(), "d_model": 32,
              "n_mels": 20, "encoder": dict(stack, causal=False),
              "decoder": dict(stack, causal=True), "dec_prenet_hidden": 16,
              "postnet_channels": 16, "max_pos": 512,
              "reduction_factor": 2, "compute_dtype": "bfloat16"},
    "experiment": {"optim": {"warmup_steps": 1}}})
model = M.init(cfg.model, torch.Generator().manual_seed(0), "cpu")
opt = make_optimizer(cfg.experiment.optim)
state = opt.init(list(model.parameters()))
step = make_train_step(cfg.model, opt)
g = torch.Generator().manual_seed(1)
batch = {"tokens": torch.randint(3, 40, (2, 11), generator=g),
         "token_mask": torch.arange(11)[None] < torch.tensor([[11], [7]]),
         "mel": torch.randn(2, 19, 20, generator=g),
         "mel_mask": torch.arange(19)[None] < torch.tensor([[19], [12]])}
before = [p.detach().clone() for p in model.parameters()]
losses = [float(step(model, state, batch, step_generator(0, s, "cpu"), s)
                ["loss"]) for s in range(2)]
assert all(l == l and abs(l) < 1e6 for l in losses), losses
assert state["count"] == 2
assert any(not torch.equal(a, b) for a, b in zip(before, model.parameters()))

# LSH self-attention in both stacks (sequences longer than one chunk)
lsh = dict(att, kind="lsh", num_hashes=2, chunk_length=16,
           attention_dropout=0.0)
lsh_stack = dict(stack, attention=lsh)
lsh_cfg = from_dict(Config, {
    "model": {"vocab_size": frontend_vocab_size(), "d_model": 32,
              "n_mels": 20, "encoder": dict(lsh_stack, causal=False),
              "decoder": dict(lsh_stack, causal=True), "dec_prenet_hidden": 16,
              "postnet_channels": 16, "max_pos": 512,
              "compute_dtype": "float32"},
    "experiment": {"optim": {"warmup_steps": 1}}})
model = M.init(lsh_cfg.model, torch.Generator().manual_seed(0), "cpu")
state = opt.init(list(model.parameters()))
step = make_train_step(lsh_cfg.model, opt)
batch = {"tokens": torch.randint(3, 40, (2, 40), generator=g),
         "token_mask": torch.arange(40)[None] < torch.tensor([[40], [23]]),
         "mel": torch.randn(2, 50, 20, generator=g),
         "mel_mask": torch.arange(50)[None] < torch.tensor([[50], [31]])}
lsh_losses = [float(step(model, state, batch, step_generator(0, s, "cpu"), s)
                    ["loss"]) for s in range(2)]
assert all(l == l and abs(l) < 1e6 for l in lsh_losses), lsh_losses

# a vocoder train step (flow NLL through K2's plain version)
from rtts_torch.config import SqueezeWaveConfig
from rtts_torch.models import squeezewave as SW
from rtts_torch.train.train_vocoder import make_train_step as voc_step
voc = SqueezeWaveConfig(n_mels=20, n_flows=2, n_group=32, n_early_every=4,
                        n_early_size=8, wn_layers=2, wn_channels=16,
                        hop_length=64, compute_dtype="float32")
vmodel = SW.init(voc, torch.Generator().manual_seed(0), "cpu")
state = opt.init(list(vmodel.parameters()))
vbatch = {"mel": torch.randn(2, 4, 20, generator=g),
          "audio": 0.1 * torch.randn(2, 256, generator=g)}
voc_losses = [float(voc_step(voc, opt)(vmodel, state, vbatch)["loss_vocoder"])
              for s in range(2)]
assert all(l == l and abs(l) < 1e6 for l in voc_losses), voc_losses
assert not any(m.split(".")[0] in ("jax", "rtts") for m in sys.modules
               if sys.modules[m] is not None)
print("OK", losses, lsh_losses, voc_losses)
"""


def _run_without_jax(script):
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_port_runs_without_jax():
    _run_without_jax(NO_JAX_SLICE)


def test_port_trains_without_jax():
    _run_without_jax(NO_JAX_TRAIN)


def _imported_modules(path: pathlib.Path) -> set:
    """Absolute module names that a file's import statements name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _roots(names) -> set:
    return {n.split(".")[0] for n in names}


NO_JAX_PROBE = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["rtts"] = None         # and so does any `import rtts...`
sys.modules["probe_vmem_sort"] = None   # the JAX package's probe script
import contextlib
import io
from rtts_torch.probes import probe_vmem_sort
said = io.StringIO()
with contextlib.redirect_stdout(said):
    assert probe_vmem_sort.main(["--check", "--device", "cpu"]) == 0
assert "checks OK on cpu" in said.getvalue()
assert not any(m.split(".")[0] in ("jax", "rtts", "scripts")
               for m in sys.modules if sys.modules[m] is not None)
print("OK")
"""


def test_sort_probe_runs_without_jax():
    _run_without_jax(NO_JAX_PROBE)


NO_DEPS_CLI = r"""
import sys
for name in ("jax", "rtts", "click", "yaml"):
    sys.modules[name] = None       # any import of them now raises
import contextlib
import io
import runpy
said = io.StringIO()
sys.argv = ["rtts_torch.cli", "--help"]
with contextlib.redirect_stdout(said):
    try:
        runpy.run_module("rtts_torch.cli", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
for verb in ("download", "generate-corpus", "preprocess", "train-tts",
             "train-vocoder", "predict", "serve", "export", "bench"):
    assert verb in said.getvalue(), verb
from rtts_torch.config import load_config
cfg = load_config("configs/tiny.yaml", ["model.d_model=48"])
assert cfg.model.d_model == 48 and cfg.model.encoder.attention.kind == "full"
assert cfg.experiment.optim.learning_rate == 1.0e-3
assert not any(m.split(".")[0] in ("jax", "rtts", "click", "yaml")
               for m in sys.modules if sys.modules[m] is not None)
print("OK")
"""


def test_cli_and_config_need_no_jax_click_or_yaml():
    _run_without_jax(NO_DEPS_CLI)


NO_JAX_BENCH = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["rtts"] = None         # and so does any `import rtts...`
import contextlib
import io
import json
from rtts_torch import bench
from rtts_torch.config import load_config
cfg = load_config("configs/tiny.yaml")
lines = [json.loads(bench.run_bench(cfg, "e2e", device="cpu", batch=2,
                                    token_len=16, max_frames=16, repeats=1)),
         json.loads(bench.run_bench(cfg, "kernels", device="cpu", repeats=1,
                                    shapes={"lsh": (1, 2, 2, 64, 16, 64),
                                            "ffn": (1, 16, 32, 64),
                                            "depthwise": (1, 32, 8, 3),
                                            "flash": (1, 32, 128, 2)}))]
assert [l["metric"] for l in lines] == ["text_to_wav_rtf_per_chip",
                                        "cuda_vs_plain_min_speedup"]
said = io.StringIO()
with contextlib.redirect_stdout(said):
    assert bench.main(["--config", "configs/tiny.yaml", "--which",
                       "vocoder_train", "--device", "cpu"]) == 0
assert json.loads(said.getvalue())["metric"] == "vocoder_train_rtf"
assert not any(m.split(".")[0] in ("jax", "rtts") for m in sys.modules
               if sys.modules[m] is not None)
print("OK")
"""


def test_bench_runs_without_jax():
    """``rtts_torch.bench`` (its cells and its entry point) on the CPU with
    ``jax`` and ``rtts`` blocked."""
    _run_without_jax(NO_JAX_BENCH)


NO_JAX_DATA_EVAL = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["rtts"] = None         # and so does any `import rtts...`
import contextlib
import io
import json
import pathlib
import tempfile
import numpy as np
import torch
from rtts_torch.config import load_config
from rtts_torch.data import dataset as TD, native_loader as TN
from rtts_torch.data.corpus import generate_corpus
from rtts_torch.data.preprocess import preprocess_corpus
from rtts_torch.models import reformer_tts as M
from rtts_torch.scripts import eval_decode_fidelity as EF
from rtts_torch.text import frontend_vocab_size
from rtts_torch.train.checkpoint import save_checkpoint

root = pathlib.Path(tempfile.mkdtemp())
generate_corpus(root, 4)
over = [f"dataset.data_dir={root / 'data'}", "dataset.num_workers=2",
        "dataset.max_mel_len=16"]
cfg = load_config("configs/tiny.yaml", over)
preprocess_corpus(cfg.dataset, str(root / "transcripts.txt"), device="cpu")
assert TN.calls["write_clip"] == 4 and TN.calls["trim_silence"] == 4
man = TD.Manifest.load(root / "data" / "manifest.json")
ds = TD.TextMelDataset(man, cfg.dataset)
assert ds.loader_path == "native", ds.loader_reason
batch = TD.EpochBatcher(ds, 2).batch_at(1)
crops = TD.MelAudioDataset(man, cfg.dataset, 1024).sample(
    np.random.default_rng(0), 2)
assert TN.calls["fill_batch"] == 1 and TN.calls["fill_crops"] == 1
model_cfg = cfg.model.__class__(**{**cfg.model.__dict__,
                                   "vocab_size": frontend_vocab_size()})
save_checkpoint(root / "tts", M.init(model_cfg, torch.Generator().manual_seed(
    0), "cpu"), None, 1)
said = io.StringIO()
with contextlib.redirect_stdout(said):
    out = EF.main(["-c", "configs/tiny.yaml"] + [a for o in over
                                                  for a in ("-o", o)] + [
        "--ckpt", str(root / "tts"), "--modes", "recompute,kv_lsh",
        "--device", "cpu"])
assert json.loads(said.getvalue().strip().splitlines()[-1]) == out
assert sorted(out["results"]) == ["kv_lsh", "recompute"]
assert TN.SRC == pathlib.Path("rtts_torch/csrc/rtts_native.cc").resolve()
assert not any(m.split(".")[0] in ("jax", "rtts", "scripts")
               for m in sys.modules if sys.modules[m] is not None)
print("OK")
"""


def test_native_loader_and_eval_run_without_jax():
    """The native data path (preprocess, ``fill_batch``, ``fill_crops``)
    and the decode-fidelity evaluation on the CPU with ``jax`` and
    ``rtts`` blocked; the library's source is the port's own copy."""
    _run_without_jax(NO_JAX_DATA_EVAL)


def test_port_names_no_file_of_the_jax_package_native_dir():
    """No module of the port names a path under ``native/`` (the port
    builds ``rtts_torch/csrc/rtts_native.cc``)."""
    for path in sorted((ROOT / "rtts_torch").rglob("*.py")):
        assert not re.search(r"native/rtts_native|[\"']native/|"
                             r"/ *[\"']native[\"']|[\"']native[\"'] */",
                             path.read_text()), path


def test_port_imports_cover_the_probes_and_name_no_script():
    """The import guard reads the probes too, and no module of the port
    imports the JAX package's scripts."""
    files = sorted((ROOT / "rtts_torch").rglob("*.py"))
    assert ROOT / "rtts_torch" / "probes" / "probe_vmem_sort.py" in files
    for path in files + [ROOT / "chip_smoke.py"]:
        names = _imported_modules(path)
        assert not _roots(names) & {"scripts", "probe_vmem_sort"}, (
            path, sorted(names))


def test_chip_smoke_imports_only_the_port():
    names = _imported_modules(ROOT / "chip_smoke.py")
    assert {"rtts_torch.infer.synthesize",
            "rtts_torch.train.train_tts"} <= names
    assert not _roots(names) & {"jax", "jaxlib", "rtts"}, sorted(names)


def test_port_imports_nothing_of_the_jax_package():
    files = sorted((ROOT / "rtts_torch").rglob("*.py"))
    assert len(files) > 25
    for name in ("cli.py", "yaml_subset.py", "data/corpus.py",
                 "data/preprocess.py", "data/download.py",
                 "data/versioning.py", "utils/tracking.py",
                 "utils/profiling.py", "parallel/mesh.py",
                 "parallel/sharding.py", "parallel/serving.py",
                 "parallel/training.py", "parallel/collectives.py",
                 "parallel/seq_parallel.py", "parallel/pipeline.py",
                 "infer/export.py", "infer/draws.py", "ops/registry.py",
                 "bench.py", "data/native_loader.py",
                 "scripts/eval_decode_fidelity.py"):
        assert ROOT / "rtts_torch" / name in files, name
    for path in files + [ROOT / "chip_smoke.py"]:
        names = _imported_modules(path)
        assert not _roots(names) & {"jax", "jaxlib", "rtts", "click",
                                    "yaml"}, (path, sorted(names))


def test_port_reads_every_stack_config_field():
    """Every ``ReformerStackConfig`` field is read by the port: as
    ``cfg.<field>`` or by name outside ``rtts_torch/config.py``, or, for
    the knobs that config.py's own resolvers read (``resolve_reversible``'s
    budget), as an attribute there (the dataclass declares its fields
    without one).  The sequence- and pipeline-parallel knobs included."""
    import dataclasses

    from rtts_torch.config import ReformerStackConfig

    config_py = ROOT / "rtts_torch" / "config.py"
    text = "\n".join(p.read_text()
                     for p in sorted((ROOT / "rtts_torch").rglob("*.py"))
                     if p != config_py)
    fields = [f.name for f in dataclasses.fields(ReformerStackConfig)]
    assert {"seq_parallel_axis", "seq_parallel_exchange", "pipeline_axis",
            "pipeline_microbatches", "pipeline_remat",
            "pipeline_interleave"} <= set(fields)
    unread = [f for f in fields
              if not re.search(rf"\.{f}\b|[\"']{f}[\"']", text)]
    assert unread == ["auto_plain_budget_mb"], unread
    assert re.search(r"\.auto_plain_budget_mb\b", config_py.read_text())


def test_chip_smoke_defines_each_top_level_name_once():
    """A later phase's helper must not rebind an earlier phase's name."""
    bound = []
    for node in ast.parse((ROOT / "chip_smoke.py").read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            bound.append(node.name)
        elif isinstance(node, ast.Assign):
            bound += [n.id for t in node.targets for n in ast.walk(t)
                      if isinstance(n, ast.Name)]
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            bound += [(a.asname or a.name).split(".")[0] for a in node.names]
    assert len(bound) > 100
    assert sorted({n for n in bound if bound.count(n) > 1}) == []


def test_chip_smoke_base_config_equals_base_yaml():
    import chip_smoke

    assert chip_smoke.BASE_CONFIG == load_yaml(ROOT / "configs" / "base.yaml")


def test_chip_smoke_longform_config_equals_longform_yaml():
    import chip_smoke

    assert chip_smoke.LONGFORM_CONFIG == load_yaml(
        ROOT / "configs" / "longform_8k.yaml")

def test_chip_smoke_serving_fast_config_equals_serving_fast_yaml():
    import chip_smoke

    assert chip_smoke.SERVING_FAST_CONFIG == load_yaml(
        ROOT / "configs" / "serving_fast.yaml")


def test_chip_smoke_parity_local_config_equals_parity_local_yaml():
    import chip_smoke

    assert chip_smoke.PARITY_LOCAL_CONFIG == load_yaml(
        ROOT / "configs" / "parity_local.yaml")


def test_chip_smoke_flagship_vocoder_settings_equal_flagship_yaml():
    """Phase 22's flagship step: base.yaml's vocoder with flagship.yaml's
    vocoder settings is flagship.yaml's vocoder."""
    import chip_smoke

    base = load_yaml(ROOT / "configs" / "base.yaml")["vocoder"]
    flagship = load_yaml(ROOT / "configs" / "flagship.yaml")["vocoder"]
    assert {**base, **chip_smoke.FLAGSHIP_VOCODER} == flagship


def test_chip_smoke_bench_phase_keeps_the_reference_shapes():
    """Phase 35 runs ``bench_e2e`` at the reference's defaults, and every
    other cell with the reference's default arguments except the cuts it
    names: ``BENCH_CUTS`` holds only the counts this slice cuts (repeats,
    longform's frames, one request a length, one concurrency and chunk
    size), ``BENCH_SIZES`` only sizes at which each serving cell's
    mechanism still works; the port's cells default to the reference's
    arguments, and ``bench_kernels`` to its shapes."""
    import inspect

    import chip_smoke
    from rtts import bench as JB
    from rtts_torch import bench as RB

    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters
                .items() if p.default is not inspect.Parameter.empty}

    cells = {"decode": "bench_decode", "e2e": "bench_e2e",
             "vocoder": "bench_vocoder", "train": "bench_train_step",
             "vocoder_train": "bench_vocoder_train",
             "longform": "bench_longform", "serving": "bench_serving",
             "continuous": "bench_continuous", "latency": "bench_latency",
             "kernels": "bench_kernels"}
    for mode, name in cells.items():
        got, want = defaults(getattr(RB, name)), defaults(getattr(JB, name))
        got.pop("device")
        cut = {**chip_smoke.BENCH_CUTS.get(mode, {}),
               **chip_smoke.BENCH_SIZES.get(mode, {})}
        kept = {k: v for k, v in want.items() if k not in cut}
        assert {k: got[k] for k in kept} == kept, mode
        assert set(cut) <= set(got), mode
    e2e = defaults(JB.bench_e2e)
    assert chip_smoke.BENCH_E2E_CALLS == 1 + e2e["repeats"]
    assert set(chip_smoke.BENCH_CUTS) == set(RB.MODES) - {"e2e", "kernels"}
    counts = {"longform": {"max_frames"}, "serving": {"per_bucket"},
              "continuous": {"per_group"},
              "latency": {"concurrency", "chunk_sweep"}}
    for mode, kw in chip_smoke.BENCH_CUTS.items():
        assert set(kw) == {"repeats"} | counts.get(mode, set()), mode
    assert chip_smoke.BENCH_CUTS["longform"]["max_frames"] < \
        defaults(JB.bench_longform)["max_frames"]
    # the sizes: each serving cell still does what it measures
    sizes = chip_smoke.BENCH_SIZES
    assert set(sizes) == {"serving", "continuous", "latency"}
    serving = {**defaults(RB.bench_serving), **sizes["serving"]}
    assert len(set(serving["lengths"])) >= 2        # buckets differ
    assert set(serving["lengths"]) <= set(defaults(RB.bench_serving)[
        "lengths"])
    cont = {**defaults(RB.bench_continuous), **chip_smoke.BENCH_CUTS[
        "continuous"], **sizes["continuous"]}
    assert len(cont["lengths"]) * cont["per_group"] > cont["slots"]
    assert min(cont["lengths"]) > cont["segment_frames"]
    assert max(cont["lengths"]) % cont["segment_frames"] == 0
    lat = {**defaults(RB.bench_latency), **chip_smoke.BENCH_CUTS["latency"],
           **sizes["latency"]}
    assert all(lat["max_frames"] >= 2 * c for c in lat["chunk_sweep"])
    assert lat["lengths"][0] <= lat["max_frames"]
    # the reference's bench_kernels shapes, written inline in its source
    source = inspect.getsource(JB.bench_kernels)
    b, h, nh, l, c, d = RB.KERNEL_SHAPES["lsh"]
    assert f"b, h, nh, l, c, d = {b}, {h}, {nh}, {l}, {c}, {d}" in source
    b, rows, dm, dff = RB.KERNEL_SHAPES["ffn"]
    assert f"dm, dff = {dm}, {dff}" in source
    assert f"({b}, {rows}, dm)" in source
    b, lsq, cch, taps = RB.KERNEL_SHAPES["depthwise"]
    assert f"cch, lsq, ks = {cch}, {lsq}, {taps}" in source
    assert f"({b}, lsq, cch)" in source
    b, l, dm, heads = RB.KERNEL_SHAPES["flash"]
    assert f"attention_init(jax.random.PRNGKey(7), {dm}, {heads}, " \
        f"{dm // heads}" in source
    assert f"({b}, {l}, {dm})" in source and f"num_heads={heads}" in source


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_inference_dropout_statistics(rate):
    x = torch.ones(200_000)
    y = dropout(x, rate, torch.Generator().manual_seed(1))
    zero = (y == 0).float().mean().item()
    assert abs(zero - rate) < 0.01
    np.testing.assert_allclose(y[y != 0].numpy(), 1.0 / (1.0 - rate),
                               rtol=1e-6)
    assert torch.equal(dropout(x, 0.0, None), x)


def test_prenet_dropout_follows_its_generator():
    net = PrenetMLP(8, 16, 12, generator=torch.Generator().manual_seed(0))
    x = torch.randn(64, 8, generator=torch.Generator().manual_seed(1))

    def run(seed, rate=0.5):
        with torch.no_grad():
            return net(x, rate, torch.Generator().manual_seed(seed))

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    assert torch.equal(run(3, rate=0.0), run(4, rate=0.0))


def _c_kind(arg: str):
    """The ctypes kind of one C parameter declaration."""
    if "*" in arg:
        return ctypes.c_void_p
    if "unsigned" in arg or "uint32_t" in arg:
        return ctypes.c_uint
    return {"int": ctypes.c_int, "float": ctypes.c_float}[arg.split()[-2]]


def _c_entry_points() -> dict:
    """Each ``extern "C" int rtts_*(...)`` of the kernel sources, its
    argument-list macros expanded: its arguments as ctypes kinds."""
    found = {}
    for path in sorted((ROOT / "rtts_torch" / "csrc").glob("*.cu")):
        text = path.read_text().replace("\\\n", " ")
        for macro, body in re.findall(r"#define (RTTS_\w+) ([^\n]*)", text):
            text = text.replace(f"({macro},", f"({body},").replace(
                f", {macro})", f", {body})")
        for name, args in re.findall(r'extern "C" int (rtts_\w+)\(([^)]*)\)',
                                     text):
            found[name] = [_c_kind(a.strip()) for a in args.split(",")]
    return found


def test_every_c_entry_point_has_a_signature():
    assert sorted(_c_entry_points()) == sorted(SIGNATURES)


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_signature_matches_the_c_prototype(name):
    assert _c_entry_points()[name] == SIGNATURES[name], name


def test_rank_processes_run_without_jax(tmp_path):
    """Two rank processes (gloo, a file:// store) of the parallel tests'
    rank module, whose first act is to block ``jax`` and ``rtts``, train a
    tiny model data- and tensor-parallel and report nothing of either
    imported."""
    from tests.test_torch_parallel import collect, spawn

    cfg = {"vocab_size": 40, "d_model": 16, "n_mels": 8,
           "dec_prenet_hidden": 8, "postnet_channels": 8, "max_pos": 64,
           "compute_dtype": "float32"}
    stack = {"num_layers": 1, "d_model": 16, "d_ff": 32,
             "attention": {"kind": "full", "num_heads": 2, "head_dim": 8}}
    cfg["encoder"], cfg["decoder"] = stack, dict(stack, causal=True)
    from rtts_torch import config as TC
    from rtts_torch.models import reformer_tts as TM

    tcfg = TC.from_dict(TC.ReformerTTSConfig, cfg)
    model = TM.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    inputs = {f"p/{k.replace('.', '/')}": v.numpy()
              for k, v in model.state_dict().items()}
    rng = np.random.default_rng(0)
    inputs.update({"b/0/tokens": rng.integers(3, 40, (2, 8)).astype(np.int32),
                   "b/0/token_mask": np.ones((2, 8), bool),
                   "b/0/mel": rng.standard_normal((2, 12, 8)).astype(
                       np.float32),
                   "b/0/mel_mask": np.ones((2, 12), bool)})
    cases = [{"kind": "train", "name": name, "model": TC.to_dict(tcfg),
              "optim": {}, "params": "p", "batches": "b", "steps": 1,
              **mesh} for name, mesh in (("dp", {"dp": 2}), ("tp", {"mp": 2}))]
    outs = collect(tmp_path, spawn(tmp_path, 2, cases, inputs))
    for out in outs:
        assert bool(out["blocked"])
        for name in ("dp", "tp"):
            assert np.isfinite(out[f"{name}/metric/0/loss"])
