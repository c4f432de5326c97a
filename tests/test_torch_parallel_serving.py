"""Sharded serving in the port against the JAX package, on the CPU: the
counterparts of ``tests/test_serving_tp.py``.

Two rank processes (``tests/torch_parallel_ranks.py``, JAX and the JAX
package blocked, gloo) run, in one group: ``decode_greedy`` on
tensor-parallel weights (model parallel 2: one head a rank) in kv_full and
kv_lsh_chunk, ``serve_batch`` on tensor-parallel weights, and
``Synthesizer(mesh=...)`` over data parallel 2 with 3 texts (the batch
padded by repeating the last request, then trimmed), and over model
parallel 2 with the encoder's sequence split (``seq_parallel_axis``,
chunks of 4 so that the split engages; the tokens unpadded, so that the
encoder pads them to a multiple of the 2 ranks) and the decoder
tensor-parallel.  The JAX side runs the
one-device reference while the ranks run; its own tests hold its sharded
runs equal to it.  The model is ``tests/test_torch_decode_modes.py``'s
(d 32, 2 + 2 layers, 2 heads x 16, n_mels 20, f32, every dropout 0; the
LSH decoder with ``hash_seed`` 5, whose rotations, drawn by JAX for all
heads, each rank receives whole and slices to its head).

Tolerances: the mel (after the postnet) and the stop logits max |port -
JAX| / max(1, |JAX|) 1e-4 (``tests/test_torch_serving.py``'s), lengths
equal; stops pinned by ``stop_threshold`` 2.0 where the run takes one.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtts import config as JC
from rtts.infer import decode as JD
from rtts.infer import serving as JS
from rtts.infer.synthesize import Synthesizer as JSynth
from rtts.models import reformer_tts as JM
from rtts.text import vocab_size
from tests.test_torch_decode_modes import jax_cfg, scaled_err
from tests.test_torch_parallel import collect, spawn
from tests.test_torch_serving import full_cfg
from torch_twin import one_thread  # noqa: F401  (autouse)


TOL = 1e-4
MAX_FRAMES = 32
TEXTS = ["hello world", "a second line", "third"]
SP_TEXTS = ["hello world", "a second line.", "third"]   # 15 tokens


def _params(prefix, jp):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jp))[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[f"{prefix}/{key}"] = leaf
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(3)
    inputs, cases, want = {}, [], {}
    for kind, mode in (("full", "kv_full"), ("lsh", "kv_lsh_chunk")):
        cfg = jax_cfg(kind)
        jp = JM.init(jax.random.PRNGKey(1), cfg)
        tokens = jnp.asarray(rng.integers(3, vocab_size(), (2, 16)),
                             jnp.int32)
        mask = jnp.arange(16)[None, :] < jnp.asarray([16, 11])[:, None]
        memory = JM.encode(jp, cfg, tokens, mask)
        name = f"decode_{mode}"
        inputs.update(_params(f"{name}/p", jp))
        inputs[f"{name}/memory"] = np.asarray(memory)
        inputs[f"{name}/mask"] = np.asarray(mask)
        rots, _ = JD._decode_rotations(cfg, jax.random.PRNGKey(0),
                                       MAX_FRAMES)
        for i, r in enumerate(rots):
            inputs[f"{name}/rot/{i}"] = np.asarray(r)
        cases.append({"kind": "decode", "name": name,
                      "model": JC.to_dict(cfg), "params": f"{name}/p",
                      "mp": 2,
                      "mode": mode, "max_frames": MAX_FRAMES,
                      "stop_threshold": 2.0})
        want[name] = (cfg, jp, memory, mask, mode)

    cfg = jax_cfg("full")
    jp = JM.init(jax.random.PRNGKey(2), cfg)
    n = 5
    tokens = rng.integers(3, vocab_size(), (n, 16)).astype(np.int32)
    mask = np.ones((n, 16), bool)
    budgets = np.asarray([32, 16, 32, 16, 32], np.int32)
    inputs.update(_params("serve/p", jp))
    inputs.update({"serve/tokens": tokens, "serve/mask": mask,
                   "serve/budgets": budgets})
    cases.append({"kind": "serve_batch", "name": "serve",
                  "model": JC.to_dict(cfg), "params": "serve/p", "mp": 2,
                  "capacity": 32, "slots": 2, "segment": 16})

    jcfg, _ = full_cfg(jax_cfg("full"), pad_to_multiple=16)
    sp = JM.init(jax.random.PRNGKey(4), jcfg.model)
    inputs.update(_params("synth/p", sp))
    cases.append({"kind": "synth", "name": "synth",
                  "config": JC.to_dict(jcfg), "params": "synth/p", "dp": 2,
                  "texts": TEXTS, "max_frames": MAX_FRAMES})

    jcfg1, _ = full_cfg(jax_cfg("full"), pad_to_multiple=1)
    enc = dataclasses.replace(
        jcfg1.model.encoder, seq_parallel_axis="model",
        attention=dataclasses.replace(jcfg1.model.encoder.attention,
                                      chunk_length=4))
    split = dataclasses.replace(jcfg1, model=dataclasses.replace(
        jcfg1.model, encoder=enc))
    cases.append({"kind": "synth", "name": "synth_sp",
                  "config": JC.to_dict(split), "params": "synth/p", "mp": 2,
                  "texts": SP_TEXTS, "max_frames": MAX_FRAMES})

    work = tmp_path_factory.mktemp("torch_parallel_serving")
    procs = spawn(work, 2, cases, inputs)
    try:   # the JAX side while the ranks run
        return _references(want, jp, cfg, tokens, mask, budgets, jcfg,
                           sp, jcfg1), collect(work, procs)
    except BaseException:
        collect(work, procs)
        raise


def _references(want, jp, cfg, tokens, mask, budgets, jcfg, sp, jcfg1):
    ref = {}
    for name, (c, p, memory, m, mode) in want.items():
        ref[name] = JD.decode_greedy(p, c, memory, m, MAX_FRAMES,
                                     rng=jax.random.PRNGKey(0),
                                     stop_threshold=2.0, mode=mode)
    ref["serve"] = JS.serve_batch(jp, cfg, jnp.asarray(tokens),
                                  jnp.asarray(mask), jnp.asarray(budgets),
                                  32, slots=2, segment_frames=16,
                                  stop_threshold=2.0,
                                  rng=jax.random.PRNGKey(0))
    ref["synth"] = JSynth(jcfg, sp, max_frames=MAX_FRAMES).text_to_mel(TEXTS)
    ref["synth_sp"] = JSynth(jcfg1, sp,
                             max_frames=MAX_FRAMES).text_to_mel(SP_TEXTS)
    return ref


@pytest.mark.parametrize("mode", ["kv_full", "kv_lsh_chunk"])
def test_tp_decode_matches_jax(runs, mode):
    ref, outs = runs
    want = ref[f"decode_{mode}"]
    for out in outs:
        got = {k.split("/")[-1]: v for k, v in out.items()
               if k.startswith(f"decode_{mode}/")}
        np.testing.assert_array_equal(got["lengths"],
                                      np.asarray(want.lengths))
        assert scaled_err(got["mel"], want.mel_post) < TOL
        assert scaled_err(got["stop_logits"], want.stop_logits) < TOL
        if mode == "kv_lsh_chunk":   # one draw of all heads a layer
            assert list(got["draws"]) == [2, 2]


def test_serve_batch_tp_matches_jax(runs):
    ref, outs = runs
    want_mel, want_len = ref["serve"]
    for out in outs:
        np.testing.assert_array_equal(out["serve/lengths"],
                                      np.asarray(want_len))
        assert scaled_err(out["serve/mel"], want_mel) < TOL


def test_synthesizer_dp_pads_and_matches_jax(runs):
    ref, outs = runs
    want_mel, want_len = ref["synth"]
    for out in outs:
        assert out["synth/mel"].shape == want_mel.shape  # padding trimmed
        np.testing.assert_array_equal(out["synth/lengths"], want_len)
        assert scaled_err(out["synth/mel"], want_mel) < TOL


def test_synthesizer_seq_parallel_encoder_pads_and_matches_jax(runs):
    """The encoder's sequence split over 2 model ranks, the tokens of an
    odd length padded to an even one: mel and lengths equal JAX's
    one-device Synthesizer's (masked padding changes no value)."""
    from rtts.text import encode_batch

    ref, outs = runs
    want_mel, want_len = ref["synth_sp"]
    tokens, _ = encode_batch(SP_TEXTS, pad_to_multiple=1)
    assert tokens.shape[1] % 2 == 1   # the encoder had to pad
    for out in outs:
        np.testing.assert_array_equal(out["synth_sp/lengths"], want_len)
        assert scaled_err(out["synth_sp/mel"], want_mel) < TOL
