"""Deployment export in the port (``rtts_torch/infer/export.py``) on the
CPU: the counterparts of ``tests/test_export.py``, and what an export must
hold beyond them.

- The manifest; the TTS artifacts (encoder, decode step, postnet finish)
  against the port's live ``Synthesizer`` with the same seed and the
  decoder prenet's dropout on; the batched and the b1 vocoder against
  ``squeezewave.infer`` with z from a generator seeded 0; chunked,
  deterministic text -> wav; truncation at ``token_len``; the format
  rejection; ``_pick_batch``; a two-rank gloo export of a tensor-parallel
  ``Synthesizer`` (``tests/torch_parallel_ranks.py``) against the
  one-device one, and its ``gather_sharded=False`` refusal.
- The artifact against the JAX package's live ``Synthesizer`` on weights
  carried over with ``rtts_torch.convert`` (every dropout 0): lengths
  equal, mel within ``tests/test_torch_slice.py``'s ``TOL``.
- Each artifact's graph holds one ``torch.ops.rtts.*`` node per kernel
  launch its config reaches (``flash_fwd`` per full encoder layer,
  ``lsh_attend_fwd``, ``sort_by_bucket`` and, with ``use_pallas_ffn``,
  ``ffn_fused`` per LSH layer, ``depthwise_conv1d`` per WN layer of every
  flow) and none of their plain versions' softmax, sort or grouped
  convolution, in kv_full, kv_lsh, kv_lsh_chunk and auto.
- ``torch.library.opcheck`` on each of the five operators.
- ``ExportedSynthesizer`` in a subprocess that cannot import the model
  code; the Griffin-Lim fallback of a TTS-only export; a CUDA artifact
  without a card raises.

Model: d 32, 2 + 2 layers, 2 heads x 16, n_mels 20, f32; the vocoder 2
flows of 2 WN layers.  Tolerances: against the live port rtol 1e-5 / atol
1e-4 on the mel (the reference test's; the runs are bit-equal here), 1e-5
on audio; against JAX ``TOL`` = 1e-4 relative to max(1, |ref|).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rtts import config as JC
from rtts.infer.synthesize import Synthesizer as JSynth
from rtts.models import reformer_tts as JM
from rtts_torch.attention import lsh as TL
from rtts_torch.config import Config, from_dict
from rtts_torch.convert import from_numpy_tree
from rtts_torch.infer import draws
from rtts_torch.infer.export import ExportedSynthesizer, export_synthesizer
from rtts_torch.infer.synthesize import Synthesizer
from rtts_torch.models import reformer_tts as M
from rtts_torch.models import squeezewave as SW
from rtts_torch.models import stack as ST
from rtts_torch.nn.layers import dropout
from rtts_torch.ops import registry
from rtts_torch.text import frontend_vocab_size
from tests.test_torch_decode_modes import jax_cfg
from tests.test_torch_parallel import collect, spawn
from tests.test_torch_slice import TOL, close
from torch_twin import one_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["hello world", "a longer test sentence here", "ok"]
VOCODER = {"n_mels": 20, "n_flows": 2, "n_group": 16, "n_early_every": 4,
           "n_early_size": 4, "wn_layers": 2, "wn_channels": 16,
           "hop_length": 16, "audio_segment_length": 256,
           "compute_dtype": "float32"}
ATT = {"full": {"kind": "full", "num_heads": 2, "head_dim": 16},
       "lsh": {"kind": "lsh", "num_heads": 2, "head_dim": 16,
               "chunk_length": 16, "num_hashes": 2}}


def port_config(enc="full", dec="full", vocoder=True, enc_extra=None,
                **model) -> Config:
    stack = {"d_model": 32, "d_ff": 64, "num_layers": 2}
    m = {"vocab_size": frontend_vocab_size(), "d_model": 32, "n_mels": 20,
         "encoder": dict(stack, causal=False, attention=ATT[enc],
                         **(enc_extra or {})),
         "decoder": dict(stack, causal=True, attention=ATT[dec]),
         "dec_prenet_hidden": 16, "dec_prenet_dropout": 0.5,
         "postnet_channels": 16, "max_pos": 256, "compute_dtype": "float32",
         "stop_threshold": 0.65, **model}
    data = {"model": m, "dataset": {"audio": {"n_mels": 20}}}
    if vocoder:
        data["vocoder"] = VOCODER
    return from_dict(Config, data)


def port_synth(cfg: Config, vocoder=True, max_frames=16, **kw):
    g = torch.Generator().manual_seed(0)
    return Synthesizer(cfg, M.init(cfg.model, g, "cpu"),
                       SW.init(cfg.vocoder, g, "cpu") if vocoder else None,
                       max_frames=max_frames, **kw)


def rtts_nodes(path: str) -> dict:
    """Count of each operator in an artifact's graph."""
    out: dict = {}
    for n in torch.export.load(path).graph.nodes:
        if n.op == "call_function":
            name = str(n.target)
            if name.startswith("aten.conv"):   # input channels / groups
                x, w = (a.meta["val"] for a in n.args[:2])
                if w.shape[1] != x.shape[1]:
                    name = "grouped convolution"
            out[name] = out.get(name, 0) + 1
    return out


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The two-rank export, started first: it runs while the module's
    other exports do."""
    jcfg = JC.from_dict(JC.Config, {
        "model": JC.to_dict(jax_cfg("full")),
        "dataset": {"audio": {"n_mels": 20}, "text": {"max_len": 64}}})
    jp = JM.init(jax.random.PRNGKey(4), jcfg.model)
    inputs = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jp))[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        inputs[f"p/{key}"] = leaf
    cases = [{"kind": "export", "name": "tp", "config": JC.to_dict(jcfg),
              "params": "p", "mp": 2, "max_frames": 16, "batch_sizes": [2],
              "token_len": 64}]
    work = tmp_path_factory.mktemp("torch_export_mesh")
    return work, spawn(work, 2, cases, inputs), jcfg, jp


BLOCKED_RUN = """
import sys
for name in ("jax", "rtts", "rtts_torch.models", "rtts_torch.infer.decode",
             "rtts_torch.infer.synthesize", "rtts_torch.train"):
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(1)
from rtts_torch.infer.export import ExportedSynthesizer
exp = ExportedSynthesizer(sys.argv[2])
mel, lengths = exp.text_to_mel(["hello world", "a longer test sentence here"],
                               seed=3)
wavs = exp.vocode(list(mel), [int(x) for x in lengths])
np.savez(sys.argv[3], mel=mel, lengths=lengths, *wavs)
"""


@pytest.fixture(scope="module")
def exported(tmp_path_factory, mesh_runs):
    """The main export (kv_full, b2, with the vocoder), and a process that
    serves from it with the model code blocked, started at once."""
    synth = port_synth(port_config(), mode="kv_full")
    out = str(tmp_path_factory.mktemp("export"))
    manifest = export_synthesizer(synth, out, batch_sizes=(2,), token_len=64)
    npz = os.path.join(out, "blocked_run.npz")
    proc = subprocess.Popen(
        [sys.executable, "-c", BLOCKED_RUN, ROOT, out, npz], cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"), stderr=subprocess.PIPE,
        text=True)
    return out, synth, manifest, proc, npz


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """A TTS-only export (mode auto) of JAX weights, every dropout 0."""
    jcfg = JC.from_dict(JC.Config, {
        "model": JC.to_dict(jax_cfg("full")),
        "dataset": {"audio": {"n_mels": 20}}})
    jp = JM.init(jax.random.PRNGKey(7), jcfg.model)
    cfg = from_dict(Config, JC.to_dict(jcfg))
    tm = from_numpy_tree(M.init(cfg.model, device="cpu"),
                         jax.tree.map(np.asarray, jp))
    synth = Synthesizer(cfg, tm, max_frames=32)
    out = str(tmp_path_factory.mktemp("jax_export"))
    export_synthesizer(synth, out, batch_sizes=(2,), token_len=64)
    return out, JSynth(jcfg, jp, max_frames=32), synth


# -- the reference's cases ------------------------------------------------------


def test_manifest_written(exported):
    out, synth, manifest = exported[:3]
    with open(os.path.join(out, "manifest.json")) as f:
        on_disk = json.load(f)
    assert on_disk == manifest
    assert on_disk["batch_sizes"] == [2]
    assert sorted(on_disk["artifacts"]) == [
        "encoder_b2", "finish_b2", "step_b2", "vocoder_b2"]
    for meta in on_disk["artifacts"].values():
        assert os.path.exists(os.path.join(out, meta["file"]))
    assert on_disk["torch_version"] == torch.__version__
    assert on_disk["device"] == "cpu" and "jax_version" not in on_disk
    assert (on_disk["token_len"], on_disk["max_frames"], on_disk["n_mels"]) \
        == (64, 16, 20)
    assert on_disk["decode"]["mode"] == "kv_full"
    assert on_disk["audio"]["stft"]["n_mels"] == 20


def test_tts_artifact_matches_live_synthesizer(exported):
    out, synth, _ = exported[:3]
    exp = ExportedSynthesizer(out)
    texts = TEXTS[:2]
    mel_live, len_live = synth.text_to_mel(texts, seed=3)
    mel_exp, len_exp = exp.text_to_mel(texts, seed=3)
    np.testing.assert_array_equal(len_live, len_exp)
    assert 1 < len_live.min() and len_live.max() < 16   # rows stop apart
    np.testing.assert_allclose(mel_live, mel_exp, rtol=1e-5, atol=1e-4)
    # the prenet dropout is on: another seed decodes another mel
    assert not np.array_equal(exp.text_to_mel(texts, seed=4)[0], mel_exp)


def _sw_infer(synth, padded):
    return SW.infer(synth.vocoder, synth.cfg.vocoder,
                    torch.from_numpy(padded),
                    generator=torch.Generator().manual_seed(0)).numpy()


def test_vocoder_batched_matches_sw_infer(exported):
    out, synth, _ = exported[:3]
    exp = ExportedSynthesizer(out)
    rng = np.random.default_rng(0)
    lens = [10, 7]
    mels = [rng.standard_normal((ln, 20)).astype(np.float32) for ln in lens]
    wavs = exp.vocode(mels)
    padded = np.stack([np.pad(m, ((0, synth.max_frames - m.shape[0]),
                                  (0, 0))) for m in mels])
    ref = _sw_infer(synth, padded)
    hop = synth.cfg.vocoder.hop_length
    for w, r, ln in zip(wavs, ref, lens):
        np.testing.assert_allclose(w, r[: ln * hop], rtol=1e-5, atol=1e-5)


def test_vocoder_b1_roundtrip(exported, tmp_path):
    _, synth, _ = exported[:3]
    out1 = str(tmp_path / "b1")
    export_synthesizer(synth, out1, batch_sizes=(1,), token_len=64)
    exp = ExportedSynthesizer(out1)
    length = 10
    mel = np.random.default_rng(0).standard_normal(
        (length, 20)).astype(np.float32)
    wav_exp = exp.mel_to_audio(mel, length)
    padded = np.pad(mel, ((0, synth.max_frames - length), (0, 0)))
    wav_ref = _sw_infer(synth, padded[None])[0]
    hop = synth.cfg.vocoder.hop_length
    np.testing.assert_allclose(wav_exp, wav_ref[: length * hop], rtol=1e-5,
                               atol=1e-5)


def test_e2e_call_chunks_and_is_deterministic(exported):
    out, _, _ = exported[:3]
    exp = ExportedSynthesizer(out)
    # 3 texts through batch-2 artifacts: two chunks, the last one padded
    wavs = exp(TEXTS, seed=5)
    wavs2 = exp(TEXTS, seed=5)
    assert len(wavs) == 3
    for w, w2 in zip(wavs, wavs2):
        assert w.ndim == 1 and len(w) > 0 and np.isfinite(w).all()
        np.testing.assert_array_equal(w, w2)


def test_long_text_truncates_at_token_budget(exported):
    out, _, _ = exported[:3]
    mel, lengths = ExportedSynthesizer(out).text_to_mel(["x " * 200])
    assert mel.shape[0] == 1 and int(lengths[0]) >= 1


def test_format_version_mismatch_rejected(exported, tmp_path):
    out, _, manifest = exported[:3]
    bad = tmp_path / "bad_export"
    shutil.copytree(out, bad)
    m = dict(manifest, format_version=999)
    (bad / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="format"):
        ExportedSynthesizer(str(bad))


def test_pick_batch_prefers_smallest_covering_size(exported):
    out, _, _ = exported[:3]
    exp = ExportedSynthesizer(out)
    exp.manifest["batch_sizes"] = [1, 4, 16]
    assert exp._pick_batch(1) == 1
    assert exp._pick_batch(3) == 4
    assert exp._pick_batch(16) == 16
    assert exp._pick_batch(40) == 16   # chunking handles the overflow


def test_mesh_sharded_export_roundtrips(mesh_runs):
    """Two ranks (model parallel 2, one head each) gather the weights to
    whole ones; rank 0's artifact decodes what the one-device Synthesizer
    on the same weights does, and gather_sharded=False is refused."""
    work, procs, jcfg, jp = mesh_runs
    outs = collect(work, procs)
    for out in outs:
        assert list(out["tp/artifacts"]) == [
            "encoder_b2", "finish_b2", "step_b2"]
        assert bool(out["tp/refused"]) and bool(out["blocked"])
    cfg = from_dict(Config, JC.to_dict(jcfg))
    tm = from_numpy_tree(M.init(cfg.model, device="cpu"),
                         jax.tree.map(np.asarray, jp))
    texts = TEXTS[:2]
    mel_ref, len_ref = Synthesizer(cfg, tm, max_frames=16).text_to_mel(
        texts, seed=3)
    mel_exp, len_exp = ExportedSynthesizer(
        str(work / "export_tp")).text_to_mel(texts, seed=3)
    np.testing.assert_array_equal(len_exp, len_ref)
    np.testing.assert_allclose(mel_exp, mel_ref, rtol=1e-5, atol=1e-4)


# -- beyond the reference ---------------------------------------------------------


def test_artifact_matches_jax_synthesizer(jax_export):
    out, jsynth, _ = jax_export
    texts = TEXTS[:2]
    want_mel, want_len = jsynth.text_to_mel(texts)
    got_mel, got_len = ExportedSynthesizer(out).text_to_mel(texts)
    np.testing.assert_array_equal(got_len, want_len)
    close(got_mel, want_mel, TOL)


def test_tts_only_export_falls_back_to_griffin_lim(jax_export):
    out, _, synth = jax_export
    exp = ExportedSynthesizer(out)
    assert exp._vocoder_batch() is None
    texts = TEXTS[:2]
    for got, want in zip(exp(texts, seed=1), synth(texts, seed=1)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cuda_artifact_without_a_card_raises(exported, tmp_path,
                                             monkeypatch):
    out, _, manifest = exported[:3]
    card = tmp_path / "card"
    card.mkdir()
    (card / "manifest.json").write_text(json.dumps(dict(manifest,
                                                        device="cuda")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        ExportedSynthesizer(str(card))


GRAPH_CASES = {
    # name: (encoder, decoder, mode, encoder options); kv_full and auto
    # are the ``exported`` and ``jax_export`` fixtures' artifacts
    "kv_lsh": ("full", "lsh", "kv_lsh", None),
    "kv_lsh_chunk": ("full", "lsh", "kv_lsh_chunk", None),
    "lsh_ffn": ("lsh", "full", "auto", {"use_pallas_ffn": True}),
}


def _check_encoder_graph(path, layers, lsh=False, ffn=False):
    got = rtts_nodes(path)
    want = ({"rtts.lsh_attend_fwd.default": layers,
             "rtts.sort_by_bucket.default": layers} if lsh
            else {"rtts.flash_fwd.default": layers})
    if ffn:
        want["rtts.ffn_fused.default"] = layers
    assert {k: v for k, v in got.items() if k.startswith("rtts.")} == want
    for plain in ("aten.softmax.int", "aten.sort.default",
                  "aten.sort.stable", "aten.argsort.default"):
        assert plain not in got


@pytest.mark.parametrize("name", ["kv_full", "auto"])
def test_graph_holds_the_kernel_ops(request, name):
    """The encoder artifact calls K1's operator once a full layer and none
    of its plain version's softmax."""
    out, synth = request.getfixturevalue(
        {"kv_full": "exported", "auto": "jax_export"}[name])[:2]
    manifest = ExportedSynthesizer(out).manifest
    assert manifest["decode"]["mode"] == "kv_full"
    _check_encoder_graph(os.path.join(out, "encoder_b2.pt2"),
                         synth.cfg.model.encoder.num_layers)


@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_graph_holds_the_lsh_kernel_ops(name, tmp_path, monkeypatch):
    """The LSH decode modes and an LSH encoder (with K6): the encoder
    artifact calls each operator its layers reach once a layer, and none
    of their plain versions; the decode equals the live one.
    use_pallas_ffn takes K6 on the card only, so the case forces the
    stack's gate, as on a CUDA tensor."""
    enc, dec, mode, enc_extra = GRAPH_CASES[name]
    if enc_extra:
        monkeypatch.setattr(ST, "use_ffn_kernel", lambda x: True)
    cfg = port_config(enc, dec, vocoder=False, enc_extra=enc_extra,
                      stop_threshold=2.0)
    synth = port_synth(cfg, vocoder=False, mode=mode)
    out = str(tmp_path / name)
    manifest = export_synthesizer(synth, out, batch_sizes=(1,),
                                  token_len=64)
    _check_encoder_graph(os.path.join(out, "encoder_b1.pt2"),
                         cfg.model.encoder.num_layers, lsh=enc == "lsh",
                         ffn=bool(enc_extra))
    assert manifest["decode"]["mode"] == (mode if mode != "auto"
                                          else "kv_full")
    assert (manifest["decode"]["rotations"] is not None) == (dec == "lsh")
    texts = TEXTS[:1]
    live, live_len = synth.text_to_mel(texts, seed=2)
    art, art_len = ExportedSynthesizer(out).text_to_mel(texts, seed=2)
    np.testing.assert_array_equal(art_len, live_len)
    np.testing.assert_allclose(art, live, rtol=1e-5, atol=1e-4)


def test_vocoder_graph_holds_k2_per_wn_layer(exported):
    out, synth, _ = exported[:3]
    got = rtts_nodes(os.path.join(out, "vocoder_b2.pt2"))
    vcfg = synth.cfg.vocoder
    assert got["rtts.depthwise_conv1d.default"] == \
        vcfg.n_flows * vcfg.wn_layers
    assert "grouped convolution" not in got


def test_runner_loads_without_model_code(exported):
    """``ExportedSynthesizer`` serves in a process where the model code,
    the decode, the live Synthesizer, the trainers and JAX cannot be
    imported, and gives what it gives here."""
    out, _, _, proc, npz = exported
    try:
        _, err = proc.communicate(timeout=300)
    finally:   # a hung runner fails this test, not the run
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    exp = ExportedSynthesizer(out)
    mel, lengths = exp.text_to_mel(TEXTS[:2], seed=3)
    wavs = exp.vocode(list(mel), [int(x) for x in lengths])
    with np.load(npz) as z:
        np.testing.assert_array_equal(z["mel"], mel)
        np.testing.assert_array_equal(z["lengths"], lengths)
        for i, w in enumerate(wavs):
            np.testing.assert_array_equal(z[f"arr_{i}"], w)


def _op_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    # (B, L, H, d) viewed as (B, H, L, d), as the attention hands them over
    q, k, v = (r(2, 8, 2, 16).transpose(1, 2) for _ in range(3))
    mask = torch.arange(8)[None, :] < torch.tensor([[8], [5]])
    qc, kc, vc = r(1, 2, 4, 4, 16), r(1, 2, 4, 4, 16), r(1, 2, 4, 4, 16)
    pos = torch.randperm(16, generator=g).reshape(4, 4).expand(1, 2, 4, 4)
    return {
        "flash_fwd": (q, k, v, mask, True, True, 0.25, 0, 0.1, 7, 0, 0,
                      None),
        "depthwise_conv1d": (r(2, 12, 8), r(3, 1, 8), r(8)),
        "lsh_attend_fwd": (qc, kc, vc, pos.contiguous(),
                           torch.ones(1, 2, 4, 4, dtype=torch.bool), True, 1,
                           0, -1e9, -1e5),
        "ffn_fused": (r(10, 8), r(8), r(8), r(8, 16), r(16), r(16, 8), r(8),
                      "gelu", torch.float32),
        "sort_by_bucket": (torch.randint(0, 4, (2, 3, 16), generator=g),),
    }


@pytest.mark.parametrize("op", sorted(registry.SCHEMAS))
def test_ops_pass_opcheck(op):
    args = _op_cases()[op]
    torch.library.opcheck(getattr(torch.ops.rtts, op).default, args)


def test_decode_draws_match_the_live_draws():
    """``draws`` gives what the attention module and ``dropout`` draw
    from the same generator state."""
    a = draws.decode_rotations(11, 2, 2, 16, 2, 8, "cpu")
    gen = torch.Generator().manual_seed(11)
    b = [TL.draw_rotations(2, 16, 2, 4, gen, "cpu") for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    x = torch.ones(3, 16)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    (u,) = draws.prenet_uniforms(g1, 3, (16,), 0.5, "cpu")
    assert torch.equal(dropout(x, 0.5, g2), torch.where(u < 0.5, 2 * x,
                                                        0 * x))
    assert draws.prenet_uniforms(g1, 3, (16,), 0.0, "cpu") == []


def test_program_copies_back_a_functional_graphs_writes():
    """A graph that returns a written input as an output
    (``USER_INPUT_MUTATION``, what a functionalized export gives) writes
    the caller's tensor through ``_Program``, as ``ep.module()`` would;
    a graph that writes in place needs no copy."""
    from rtts_torch.infer.export import _Program

    class Writes(torch.nn.Module):
        def forward(self, cache, t, row):
            cache.select(0, t).copy_(row)
            return row * 2

    args = (torch.zeros(4, 3), 2, torch.arange(3.0))
    dyn = (None, torch.export.Dim.DYNAMIC, None)
    eager = torch.export.export(Writes(), args, dynamic_shapes=dyn)
    functional = eager.run_decompositions({})
    kinds = {s.kind.name for s in functional.graph_signature.output_specs}
    assert "USER_INPUT_MUTATION" in kinds
    for ep in (eager, functional):
        cache = torch.zeros(4, 3)
        out = _Program(ep)(cache, 1, torch.full((3,), 5.0))
        assert torch.equal(out, torch.full((3,), 10.0))
        want = torch.zeros(4, 3)
        want[1] = 5.0
        assert torch.equal(cache, want)
