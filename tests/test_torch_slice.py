"""The rtts_torch serving slice against rtts (JAX), at small size.

encode + ``decode_greedy(mode="kv_full")`` (the JAX side unstaged, as the
port runs) on mel, lengths and stop logits, once at the bench's stop
threshold 2.0 (never stops) and once at a threshold that stops rows at
different steps; then the vocoder on that mel with the same z.  The
decoder prenet's dropout is 0 in this config: its random bits cannot match
across frameworks.  And the bridge: parameters from a live pytree and from
a ``leaves.npz`` that ``rtts.train.checkpoint.save_checkpoint`` wrote give
identical outputs.

Tolerance: 1e-4 max abs error relative to max(1, |reference|) — float32 on
both sides, summation order compounded through the autoregressive loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtts.infer.decode import decode_greedy as jax_decode_greedy
from rtts.models import reformer_tts as JM
from rtts.models import squeezewave as JS
from rtts.train.checkpoint import save_checkpoint
from rtts_torch.convert import from_numpy_tree, load_leaves_npz
from rtts_torch.infer.decode import decode_greedy
from rtts_torch.models import reformer_tts as TM
from rtts_torch.models import squeezewave as TS
from tests.test_model_m1 import tiny_cfg
from tests.test_torch_modules import VOC_CFG, np_tree
from torch_twin import one_thread  # noqa: F401  (autouse)


TOL = 1e-4
MAX_FRAMES = 48


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, err.max()


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg(d=64)
    jp = JM.init(jax.random.PRNGKey(7), cfg)
    tm = from_numpy_tree(TM.init(cfg, device="cpu"), np_tree(jp))
    rng = np.random.default_rng(8)
    b, l = 3, 23
    tokens = rng.integers(3, cfg.vocab_size, (b, l)).astype(np.int32)
    mask = np.arange(l)[None, :] < np.asarray([l, 17, 9])[:, None]
    memory = jax.jit(lambda p, t, m: JM.encode(p, cfg, t, m))(
        jp, jnp.asarray(tokens), jnp.asarray(mask))
    with torch.no_grad():   # encode is differentiable; serving runs it so
        tmem = TM.encode(tm, cfg, torch.from_numpy(tokens).long(),
                         torch.from_numpy(mask))
    return cfg, jp, tm, tokens, mask, memory, tmem


def _decode_both(setup, threshold):
    cfg, jp, tm, tokens, mask, memory, tmem = setup
    want = jax_decode_greedy(jp, cfg, memory, jnp.asarray(mask),
                             max_frames=MAX_FRAMES, stop_threshold=threshold,
                             mode="kv_full", staged=False)
    got = decode_greedy(tm, cfg, tmem, torch.from_numpy(mask),
                        max_frames=MAX_FRAMES, stop_threshold=threshold)
    return want, got


def test_encode_matches(setup):
    *_, memory, tmem = setup
    close(tmem, memory)


def test_decode_never_stopping_matches(setup):
    want, got = _decode_both(setup, 2.0)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert (got.lengths.numpy() == MAX_FRAMES).all()
    close(got.mel_post, want.mel_post)
    close(got.stop_logits, want.stop_logits)


def _stopping_threshold(setup):
    """A threshold that stops row 0 partway and leaves a margin of 1e-3 to
    every observed probability (so 1e-6 differences cannot flip a stop)."""
    want, _ = _decode_both(setup, 2.0)
    p = np.sort(jax.nn.sigmoid(np.asarray(want.stop_logits)).ravel())
    row0 = jax.nn.sigmoid(np.asarray(want.stop_logits)[0, :MAX_FRAMES // 2])
    target = float(np.max(row0))
    i = int(np.searchsorted(p, target))
    lo = p[max(i - 1, 0)]
    assert target - lo > 2e-3, "no margin below the target probability"
    return (target + lo) / 2


def test_decode_that_stops_matches_and_vocodes(setup):
    cfg, jp, tm, *_ = setup
    want, got = _decode_both(setup, _stopping_threshold(setup))
    lengths = np.asarray(want.lengths)
    np.testing.assert_array_equal(got.lengths.numpy(), lengths)
    assert lengths.min() < MAX_FRAMES // 2 + 1
    close(got.mel_post, want.mel_post)
    close(got.stop_logits, want.stop_logits)
    # the vocoder on that mel, with the same z and a live "end" conv
    rng = np.random.default_rng(9)
    jv = np_tree(jax.jit(lambda key: JS.fold_weightnorm(JS.init(
        key, VOC_CFG)))(jax.random.PRNGKey(10)))
    for f in jv["flows"]:
        for k in ("w", "b"):
            f["wn"]["end"][k] = (0.1 * rng.standard_normal(
                f["wn"]["end"][k].shape)).astype(np.float32)
    tv = from_numpy_tree(TS.fold_weightnorm(TS.init(VOC_CFG, device="cpu")), jv)
    mel = np.array(want.mel_post)[..., :VOC_CFG.n_mels]
    l = MAX_FRAMES * VOC_CFG.hop_length // VOC_CFG.n_group
    z = rng.standard_normal((mel.shape[0], l, VOC_CFG.n_group)).astype(np.float32)
    ja = jax.jit(lambda p, mel, z: JS._infer_chunk(p, mel, z, cfg=VOC_CFG))(
        jv, mel, z)
    ta = TS._infer_chunk(tv, torch.from_numpy(mel), torch.from_numpy(z),
                         cfg=VOC_CFG)
    close(ta, ja)


def test_checkpoint_bridge_matches_live_tree(setup, tmp_path):
    cfg, jp, tm, tokens, mask, *_ = setup
    step_dir = save_checkpoint(tmp_path, {"params": jp, "step": 3}, step=3)
    loaded = load_leaves_npz(TM.init(cfg, device="cpu"), step_dir, prefix="params")
    for (name, a), (name_b, b) in zip(tm.state_dict().items(),
                                      loaded.state_dict().items()):
        assert name == name_b and torch.equal(a, b), name
    tok, msk = torch.from_numpy(tokens).long(), torch.from_numpy(mask)
    with torch.no_grad():
        mem_a = TM.encode(tm, cfg, tok, msk)
        mem_b = TM.encode(loaded, cfg, tok, msk)
    assert torch.equal(mem_a, mem_b)
    res_a = decode_greedy(tm, cfg, mem_a, msk, max_frames=8,
                          stop_threshold=2.0)
    res_b = decode_greedy(loaded, cfg, mem_b, msk, max_frames=8,
                          stop_threshold=2.0)
    assert torch.equal(res_a.mel_post, res_b.mel_post)
    with pytest.raises(KeyError, match="missing"):
        load_leaves_npz(TM.init(cfg, device="cpu"), step_dir, prefix="opt_state")


def test_synthesizer_text_to_mel_matches(setup):
    """The user entry point: text -> tokens -> mel and lengths, against the
    JAX Synthesizer (decode mode "auto" resolves to kv_full on both)."""
    from rtts.config import Config, from_dict, to_dict
    from rtts.infer.synthesize import Synthesizer as JaxSynthesizer
    from rtts_torch.infer.synthesize import Synthesizer

    cfg, jp, tm, *_ = setup
    full = from_dict(Config, {"model": to_dict(cfg),
                              "dataset": {"audio": {"n_mels": cfg.n_mels}}})
    texts = ["hello world", "a longer sentence, with punctuation!"]
    want_mel, want_len = JaxSynthesizer(full, jp, max_frames=32).text_to_mel(texts)
    got_mel, got_len = Synthesizer(full, tm, max_frames=32).text_to_mel(texts)
    np.testing.assert_array_equal(got_len, want_len)
    close(got_mel, want_mel)
