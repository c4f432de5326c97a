"""The rtts_torch serving surfaces against rtts (JAX), small, on the CPU:
``serve_batch``, ``serve_pool``, ``ServingEngine``, ``predict_frames`` and
the Synthesizer's ``serve*`` methods; then the reference's own invariants
inside the port.

One parameter tree made by the JAX package's init is loaded into the port
(the config of ``tests/test_torch_decode_modes.py``: d 32, 2 + 2 layers, 2
heads x 16, n_mels 20, float32, every dropout rate 0: JAX's Threefry bits
cannot be matched).  JAX runs at "highest" matmul precision
(tests/conftest.py).  Budgets are multiples of the segment.

Tolerances:
- port against JAX, the mel (after the postnet), max |port - JAX| /
  max(1, |JAX|): 1e-4 (summation order compounded through the AR loop),
  the lengths equal; stops pinned by ``stop_threshold`` 2.0, or at a
  threshold with a margin of 1e-3 to every observed stop probability;
- a slot admitted at t = 0 against ``decode_greedy(kv_full, staged=False)``
  1e-5 abs, a recycled slot against a fresh decode 2e-4 abs, and
  ``serve_batch`` against ``ServingEngine`` after the postnet 1e-5 abs (the
  reference's, ``tests/test_continuous.py``); with the prenet dropout on
  and the same admissions the frames before the postnet bit for bit;
- the rows zero beyond each length, exactly; bucketed ``serve`` with one
  bucket equal to pad-to-max exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtts import config as JC
from rtts.infer import serving as JS
from rtts.infer.synthesize import Synthesizer as JSynth
from rtts.models import reformer_tts as JM
from rtts_torch import config as TC
from rtts_torch.convert import from_numpy_tree
from rtts_torch.infer import decode as TD
from rtts_torch.infer import serving as TS
from rtts_torch.infer.synthesize import Synthesizer
from rtts_torch.models import reformer_tts as TM
from rtts_torch.models import squeezewave as TSW
from tests.test_torch_decode_modes import jax_cfg, scaled_err, tt

TOL = 1e-4
L = 16                      # token length
CAP, SLOTS, SEG = 64, 2, 16
BUDGETS = [16, 32, 48, 16, 32]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port: its decode steps are many tiny ops,
    and beside the suite's other workers a thread pool's barriers cost far
    more than its work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def full_cfg(mcfg, **text):
    """A whole Config (the engine and the Synthesizer read the text one)."""
    data = {"model": JC.to_dict(mcfg),
            "dataset": {"audio": {"n_mels": mcfg.n_mels},
                        "text": dict({"max_len": L}, **text)}}
    return JC.from_dict(JC.Config, data), TC.from_dict(TC.Config, data)


@pytest.fixture(scope="module")
def case():
    mcfg = jax_cfg("full")
    jcfg, tcfg = full_cfg(mcfg)
    jp = jax.jit(lambda k: JM.init(k, mcfg))(jax.random.PRNGKey(3))
    tm = from_numpy_tree(TM.init(tcfg.model, device="cpu"),
                         jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(4)
    n = len(BUDGETS)
    tokens = rng.integers(3, mcfg.vocab_size, (n, L)).astype(np.int32)
    mask = np.arange(L)[None, :] < np.asarray([L, 11, 16, 7, 13])[:, None]
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tm=tm, tokens=tokens, mask=mask)


def _jax_batch(case, budgets, thr, n=None, cfg=None):
    n = n or len(budgets)
    return JS.serve_batch(
        case["jp"], cfg or case["jcfg"].model, jnp.asarray(case["tokens"][:n]),
        jnp.asarray(case["mask"][:n]), jnp.asarray(budgets), CAP,
        slots=SLOTS, segment_frames=SEG, stop_threshold=thr,
        rng=jax.random.PRNGKey(0))


def _port_batch(case, budgets, thr, n=None, cfg=None, model=None):
    n = n or len(budgets)
    return TS.serve_batch(
        model or case["tm"], cfg or case["tcfg"].model,
        tt(case["tokens"][:n]), tt(case["mask"][:n]), torch.tensor(budgets),
        CAP, slots=SLOTS, segment_frames=SEG, stop_threshold=thr)


@pytest.fixture(scope="module")
def stop_thr(case):
    """A threshold that stops some requests before their budget, with a
    margin of 1e-3 to every stop probability the requests show (from the
    port's fresh decodes: a request's trajectory does not depend on its
    slot, and port and JAX differ by ~1e-6)."""
    tok, msk = tt(case["tokens"]).long(), tt(case["mask"])
    with torch.no_grad():
        mem = TM.encode(case["tm"], case["tcfg"].model, tok, msk)
    res = TD.decode_greedy(case["tm"], case["tcfg"].model, mem, msk,
                           max_frames=max(BUDGETS), stop_threshold=2.0,
                           staged=False)
    probs = torch.sigmoid(res.stop_logits).numpy()
    p = np.sort(np.concatenate([probs[i, :b] for i, b in
                                enumerate(BUDGETS)]))
    gaps = np.diff(p)
    # the widest gap in the upper half: some requests cross it early
    hi = len(p) // 2 + int(np.argmax(gaps[len(p) // 2:]))
    assert gaps[hi] > 2e-3, "no margin in the stop probabilities"
    return float((p[hi] + p[hi + 1]) / 2)


def _assert_lengths_and_mel(got_mel, got_len, want_mel, want_len):
    np.testing.assert_array_equal(np.asarray(got_len), np.asarray(want_len))
    assert scaled_err(got_mel, want_mel) <= TOL


# -- port against JAX ---------------------------------------------------------


@pytest.mark.parametrize("stop", ["pinned", "fires"])
def test_serve_batch_matches_jax(case, stop_thr, stop):
    thr = 2.0 if stop == "pinned" else stop_thr
    want_mel, want_len = _jax_batch(case, BUDGETS, thr)
    got_mel, got_len = _port_batch(case, BUDGETS, thr)
    _assert_lengths_and_mel(got_mel, got_len, want_mel, want_len)
    if stop == "fires":
        assert (np.asarray(want_len) < np.asarray(BUDGETS)).any()
    else:
        assert list(np.asarray(want_len)) == BUDGETS


def test_serve_batch_e4m3_matches_jax(case):
    """e4m3 rings and cross K/V (row picks and admission through bytes)."""
    jm = dataclasses.replace(case["jcfg"].model,
                             kv_cache_dtype="float8_e4m3fn")
    tm = TC.from_dict(TC.ReformerTTSConfig, JC.to_dict(jm))
    want = _jax_batch(case, BUDGETS[:3], 2.0, cfg=jm)
    got = _port_batch(case, BUDGETS[:3], 2.0, cfg=tm)
    _assert_lengths_and_mel(*got, *want)


def test_serve_pool_matches_jax(case):
    budgets = [16, 48, 32, 64, 16]
    kw = dict(class_caps=(32, 64), slots=SLOTS, segment_frames=SEG,
              stop_threshold=2.0)
    want_mels, want_len = JS.serve_pool(case["jp"], case["jcfg"].model,
                                        case["tokens"], case["mask"],
                                        budgets, rng=jax.random.PRNGKey(0),
                                        **kw)
    got_mels, got_len = TS.serve_pool(case["tm"], case["tcfg"].model,
                                      case["tokens"], case["mask"], budgets,
                                      **kw)
    np.testing.assert_array_equal(got_len, np.asarray(want_len))
    for g, w, b in zip(got_mels, want_mels, budgets):
        assert g.shape == (32 if b <= 32 else 64, 20)
        assert scaled_err(g, w) <= TOL
        assert torch.all(g[b:] == 0)
    with pytest.raises(ValueError):
        TS.serve_pool(case["tm"], case["tcfg"].model, case["tokens"],
                      case["mask"], [128], class_caps=(32, 64))


@pytest.mark.parametrize("stop", ["pinned", "fires"])
def test_engine_matches_jax(case, stop_thr, stop):
    thr = 2.0 if stop == "pinned" else stop_thr
    kw = dict(slots=SLOTS, capacity_frames=CAP, segment_frames=SEG,
              token_len=L, stop_threshold=thr, suppress_dispatch_warning=True)
    out = []
    for eng in (JS.ServingEngine(case["jcfg"], case["jp"], **kw),
                TS.ServingEngine(case["tcfg"], case["tm"], **kw)):
        ids = [eng.submit_tokens(case["tokens"][i:i + 1],
                                 case["mask"][i:i + 1], budget_frames=b)
               for i, b in enumerate(BUDGETS)]
        res = eng.run_until_drained()
        out.append([res[i] for i in ids])
    for (wm, wl), (gm, gl) in zip(*out):
        assert gl == wl
        assert scaled_err(gm, wm) <= TOL


@pytest.mark.parametrize("r", [1, 3])
def test_predict_frames_matches_jax(case, r):
    mcfg = dataclasses.replace(case["jcfg"].model, reduction_factor=r)
    jcfg, tcfg = full_cfg(mcfg, max_len=512)
    texts = ["hi", "a much longer sentence that needs many more frames ok",
             "the third one, of middling length"]
    want = JSynth(jcfg, case["jp"], max_frames=576).predict_frames(texts)
    got = Synthesizer(tcfg, case["tm"], max_frames=576).predict_frames(texts)
    assert got == want
    assert all(b % (64 * r // np.gcd(64, r)) == 0 for b in got)
    for kw in ({"frames_per_token": 2.0, "min_frames": 32}, {}):
        assert (Synthesizer(tcfg, case["tm"], max_frames=576)
                .predict_frames(texts, **kw)
                == JSynth(jcfg, case["jp"], max_frames=576)
                .predict_frames(texts, **kw))


# -- the reference's invariants, inside the port ------------------------------


def _fresh(case, i, frames, model=None, cfg=None):
    """The port's decode_greedy(kv_full, staged=False) of request i."""
    model, cfg = model or case["tm"], cfg or case["tcfg"].model
    tok, msk = tt(case["tokens"][i:i + 1]).long(), tt(case["mask"][i:i + 1])
    with torch.no_grad():
        mem = TM.encode(model, cfg, tok, msk)
    return TD.decode_greedy(model, cfg, mem, msk, max_frames=frames,
                            stop_threshold=2.0, mode="kv_full", staged=False)


def _engine(case, **kw):
    kw = dict(dict(slots=SLOTS, capacity_frames=CAP, segment_frames=SEG,
                   token_len=L, stop_threshold=2.0,
                   suppress_dispatch_warning=True), **kw)
    return TS.ServingEngine(case["tcfg"], case["tm"], **kw)


def test_slots_admitted_at_zero_match_decode_greedy(case):
    mel, lengths = _port_batch(case, [CAP, CAP], 2.0)
    eng = _engine(case)
    ids = [eng.submit_tokens(case["tokens"][i:i + 1], case["mask"][i:i + 1])
           for i in range(2)]
    res = eng.run_until_drained()
    for i in range(2):
        ref = _fresh(case, i, CAP)
        assert int(lengths[i]) == res[ids[i]][1] == CAP
        np.testing.assert_allclose(mel[i].numpy(), ref.mel_post[0].numpy(),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(res[ids[i]][0], ref.mel_post[0].numpy(),
                                   atol=1e-5, rtol=0)


def test_recycled_slots_match_fresh_decodes_and_serve_batch(case):
    """More requests than slots: each matches a fresh decode at its own
    budget (2e-4), and the engine matches serve_batch (1e-5), zero past
    each length."""
    mel, lengths = _port_batch(case, BUDGETS, 2.0)
    eng = _engine(case)
    ids = [eng.submit_tokens(case["tokens"][i:i + 1], case["mask"][i:i + 1],
                             budget_frames=b) for i, b in enumerate(BUDGETS)]
    res = eng.run_until_drained()
    assert sorted(res) == sorted(ids) and eng.idle and not eng.results
    for i, (rid, b) in enumerate(zip(ids, BUDGETS)):
        e_mel, e_len = res[rid]
        assert int(lengths[i]) == e_len == b
        np.testing.assert_allclose(e_mel, _fresh(case, i, b).mel_post[0],
                                   atol=2e-4, rtol=0)
        np.testing.assert_allclose(mel[i, :b].numpy(), e_mel, atol=1e-5,
                                   rtol=0)
        assert torch.all(mel[i, b:] == 0)


def test_prenet_dropout_engine_and_serve_batch_decode_the_same_bits(case):
    """The prenet's always-on dropout on, one generator seeded alike, the
    same admissions (N = slots, all at t = 0): the frames before the
    postnet are equal bit for bit, and differ from another seed's."""
    cfg = dataclasses.replace(case["tcfg"], model=dataclasses.replace(
        case["tcfg"].model, dec_prenet_dropout=0.5))
    budgets = [32, 48]
    frames, lengths = TS._decode_queue(
        case["tm"], cfg.model, tt(case["tokens"][:2]),
        tt(case["mask"][:2]), torch.tensor(budgets), CAP, SLOTS, SEG, 2.0,
        torch.Generator().manual_seed(11))
    eng = TS.ServingEngine(cfg, case["tm"], slots=SLOTS, capacity_frames=CAP,
                           segment_frames=SEG, token_len=L, stop_threshold=2.0,
                           seed=11, suppress_dispatch_warning=True)
    for i, b in enumerate(budgets):
        eng.submit_tokens(case["tokens"][i:i + 1], case["mask"][i:i + 1], b)
    res = eng.run_until_drained()
    assert [res[i][1] for i in range(2)] == lengths.tolist() == budgets
    for i, b in enumerate(budgets):
        assert torch.equal(eng.mel_out[i, :b], frames[i, :b])
    other, _ = TS._decode_queue(
        case["tm"], cfg.model, tt(case["tokens"][:2]), tt(case["mask"][:2]),
        torch.tensor(budgets), CAP, SLOTS, SEG, 2.0,
        torch.Generator().manual_seed(12))
    assert not torch.equal(other, frames)


def test_recycled_slot_row_is_zero_beyond_length(case):
    eng = _engine(case, slots=1)
    rid_a = eng.submit_tokens(case["tokens"][:1], case["mask"][:1], 48)
    rid_b = eng.submit_tokens(case["tokens"][1:2], case["mask"][1:2], 16)
    res = eng.run_until_drained(fetch=False)
    row_b, len_b = res[rid_b]
    assert len_b == 16 and row_b.shape == (CAP, 20)
    assert row_b[:len_b].abs().max() > 0
    assert torch.all(row_b[len_b:] == 0)
    row_a, len_a = res[rid_a]
    assert len_a == 48 and torch.all(row_a[len_a:] == 0)


def test_engine_stop_head_streaming_admission_and_checks(case):
    eng = _engine(case, stop_threshold=0.0)
    rid = eng.submit_tokens(case["tokens"][:1], case["mask"][:1])
    assert eng.run_until_drained()[rid][1] == 1
    eng = _engine(case)
    first = [eng.submit_tokens(case["tokens"][:1], case["mask"][:1], 16)
             for _ in range(2)]
    eng.step()
    late = [eng.submit_tokens(case["tokens"][1:2], case["mask"][1:2], 32)
            for _ in range(3)]
    res = eng.run_until_drained()
    assert sorted(res) == sorted(first + late)
    assert [res[i][1] for i in first + late] == [16] * 2 + [32] * 3
    with pytest.warns(UserWarning, match="serve_pool"):
        TS.ServingEngine(case["tcfg"], case["tm"], slots=2,
                         capacity_frames=64, segment_frames=16, token_len=L)
    with pytest.raises(ValueError):
        eng.submit_tokens(np.ones((1, 8), np.int32), np.ones((1, 8), bool))
    for kw in ({"segment_frames": 0}, {"capacity_frames": 0}, {"slots": 0}):
        with pytest.raises(ValueError):
            _engine(case, **kw)
    with pytest.raises(ValueError):
        TS.serve_batch(case["tm"], case["tcfg"].model, tt(case["tokens"][:1]),
                       tt(case["mask"][:1]), torch.tensor([16]), 64, slots=0)
    r2 = dataclasses.replace(case["tcfg"], model=dataclasses.replace(
        case["tcfg"].model, reduction_factor=2))
    with pytest.raises(ValueError):
        TS.ServingEngine(r2, case["tm"], capacity_frames=63,
                         suppress_dispatch_warning=True)


@pytest.fixture(scope="module")
def syn(case):
    tcfg = case["tcfg"]
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, stop_threshold=2.0), dataset=dataclasses.replace(
        tcfg.dataset, text=dataclasses.replace(tcfg.dataset.text,
                                               max_len=512)))
    vcfg = TC.SqueezeWaveConfig(
        n_mels=20, n_flows=2, n_group=32, n_early_every=4, n_early_size=8,
        wn_layers=2, wn_channels=16, hop_length=64, compute_dtype="float32")
    tcfg = dataclasses.replace(tcfg, vocoder=vcfg)
    voc = TSW.init(vcfg, torch.Generator().manual_seed(5), "cpu")
    return Synthesizer(tcfg, case["tm"], voc, max_frames=128)


TEXTS = ["aaaa", "the longest request in this tiny workload by far ok then"]


def test_serve_uniform_bucket_equals_pad_to_max_and_escalates(syn):
    """One bucket at max_frames is the pad-to-max decode; stop 2.0 pins
    every request to its budget, so escalation re-decodes at max_frames
    and without it the 64-frame quantum stays."""
    texts = ["same length a", "same length b"]
    at64 = Synthesizer(syn.cfg, syn.tts, syn.vocoder, max_frames=64)
    mels, lengths = at64.serve_to_mel(texts, frames_per_token=50.0,
                                      min_frames=64, escalate=False)
    ref_mel, ref_len = at64.text_to_mel(texts)
    for i in range(2):
        assert lengths[i] == ref_len[i] == 64
        np.testing.assert_array_equal(mels[i], ref_mel[i, :ref_len[i]])
    _, lengths = syn.serve_to_mel(["hi", "bb"], frames_per_token=2.0,
                                  min_frames=32)
    assert lengths == [128, 128]
    wavs = syn.serve(["hi", "bb"], frames_per_token=2.0, min_frames=32,
                     escalate=False)
    assert [w.shape for w in wavs] == [(64 * 64,), (64 * 64,)]


def test_serve_continuous_routes_escalates_and_vocodes(syn):
    kw = dict(frames_per_token=4.0, min_frames=32, slots=2,
              segment_frames=32, escalate=False)
    budgets = syn.predict_frames(TEXTS, 4.0, 32)
    assert budgets == [64, 128]
    rows, lengths = syn.serve_continuous_to_mel(TEXTS, fetch=False, **kw)
    assert lengths == budgets
    for row, li in zip(rows, lengths):
        # max_frames 128 on the 64-frame quantum: one class, 128 rows
        assert row.shape == (128, 20) and torch.all(row[li:] == 0)
    # the batched vocode: one infer over the class's rows, z from a
    # generator seeded 0, each waveform cut at its length
    wav_b = syn.serve_continuous(TEXTS, vocode="batched", **kw)
    want = TSW.infer(syn.vocoder, syn.cfg.vocoder, torch.stack(rows),
                     generator=torch.Generator().manual_seed(0)).numpy()
    for i, (wb, li) in enumerate(zip(wav_b, lengths)):
        np.testing.assert_array_equal(wb, want[i, :li * 64])
    mels, _ = syn.serve_continuous_to_mel(TEXTS, **dict(kw, slots=1))
    for m, row, li in zip(mels, rows, lengths):
        np.testing.assert_allclose(m, row[:li].numpy(), atol=2e-4, rtol=0)
    wav_e = syn.serve_continuous(TEXTS, vocode="exact", **kw)
    for we, li in zip(wav_e, lengths):
        assert we.shape == (li * 64,) and np.isfinite(we).all()
    assert syn.serve_continuous_to_mel(["hi", "bb"], **dict(
        kw, frames_per_token=2.0, escalate=True))[1] == [128, 128]
    with pytest.raises(ValueError):
        syn.serve_continuous(TEXTS, vocode="nope", **kw)
