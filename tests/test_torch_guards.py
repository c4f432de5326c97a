"""Guards around the rtts_torch port.

(a) The port imports neither JAX nor the JAX package ``rtts``: subprocesses
    that make ``import jax`` and ``import rtts`` fail import every module of
    ``rtts_torch``, synthesize speech (also through ``serve_continuous``
    and ``StreamingSynthesizer``) and take train steps (full and LSH
    attention, and the vocoder's) with a tiny model; and by their import statements, no module
    of the port and not ``chip_smoke.py`` names ``jax`` or ``rtts``; the
    sort probe runs its CPU check with both blocked.
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
                          capture_output=True, text=True, timeout=300)
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
    for path in files + [ROOT / "chip_smoke.py"]:
        names = _imported_modules(path)
        assert not _roots(names) & {"jax", "jaxlib", "rtts"}, (path,
                                                               sorted(names))


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
