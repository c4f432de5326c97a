"""The rtts_torch streaming surfaces against rtts (JAX), small, on the CPU:
``StreamingSynthesizer`` (mel only) in kv_full and kv_local, and
``receptive_field_squeezed``; then the reference's own invariants inside
the port: streamed mel against the full pipeline, streamed audio against
one vocoder pass with the same noise, the decoded frames against
``decode_greedy``'s step loop, and ``infer_streaming`` against ``infer``.

One parameter tree made by the JAX package's init is loaded into the port
(the configs of ``tests/test_torch_decode_modes.py``: d 32, 2 + 2 layers,
2 heads x 16, n_mels 20, float32, every dropout rate 0).  JAX runs at
"highest" matmul precision (tests/conftest.py).

Tolerances: the streamed mel against JAX's, max |port - JAX| / max(1,
|JAX|), 1e-4 (summation order through the AR loop), with the chunk shapes
and lengths equal; streamed mel against the full pipeline atol 1e-4 / rtol
1e-3 and streamed audio against one pass atol 1e-3 / rtol 1e-2 (the
reference's, ``tests/test_streaming_synth.py``); ``infer_streaming``
against ``infer`` atol 1e-4 / rtol 1e-3 (``tests/test_streaming.py``); the
decoded frames bit for bit; the receptive field exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rtts import config as JC
from rtts.infer.streaming import StreamingSynthesizer as JStream
from rtts.models import reformer_tts as JM
from rtts.models import squeezewave as JSW
from rtts_torch import config as TC
from rtts_torch.convert import from_numpy_tree
from rtts_torch.infer import decode as TD
from rtts_torch.infer import streaming as TST
from rtts_torch.infer.streaming import StreamingSynthesizer
from rtts_torch.models import reformer_tts as TM
from rtts_torch.models import squeezewave as TSW
from rtts_torch.models.reformer_tts import postnet_apply
from tests.test_torch_decode_modes import jax_cfg, scaled_err, tt
from torch_twin import one_thread  # noqa: F401  (autouse)

TOL = 1e-4
T = 32
TEXTS = ["hello world", "streams"]
VOC = TC.SqueezeWaveConfig(n_mels=20, n_flows=4, n_group=32, n_early_every=2,
                           n_early_size=8, wn_layers=2, wn_channels=16,
                           hop_length=64, compute_dtype="float32")


def configs(mcfg):
    data = {"model": JC.to_dict(mcfg), "vocoder": TC.to_dict(VOC),
            "dataset": {"audio": {"n_mels": mcfg.n_mels}}}
    return JC.from_dict(JC.Config, data), TC.from_dict(TC.Config, data)


def models(mcfg, seed):
    jcfg, tcfg = configs(mcfg)
    jp = jax.jit(lambda k: JM.init(k, mcfg))(jax.random.PRNGKey(seed))
    tm = from_numpy_tree(TM.init(tcfg.model, device="cpu"),
                         jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tm


def _vocoder(cfg):
    """A folded port vocoder with live "end" convs (at init they are zero
    and every flow is the identity on its second half)."""
    voc = TSW.init(cfg, torch.Generator().manual_seed(2), "cpu")
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for flow in voc.flows:
            for p in (flow.wn.end.w, flow.wn.end.b):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return TSW.fold_weightnorm(voc)


@pytest.fixture(scope="module")
def vocoder():
    return _vocoder(VOC)


def _with_stop(jcfg, tcfg, thr):
    def f(cfg):
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, stop_threshold=thr))
    return f(jcfg), f(tcfg)


def _stopping_threshold(tcfg, tm, text):
    """A threshold at which ``text`` stops before T, with a margin of 1e-3
    to every stop probability of its decode (port and JAX differ by
    ~1e-6)."""
    from rtts_torch.text import encode_batch

    tokens, mask = encode_batch([text])
    tok, msk = tt(tokens).long(), tt(mask)
    with torch.no_grad():
        mem = TM.encode(tm, tcfg.model, tok, msk)
    res = TD.decode_greedy(tm, tcfg.model, mem, msk, max_frames=T,
                           stop_threshold=2.0, staged=False)
    probs = torch.sigmoid(res.stop_logits[0]).numpy()
    target = float(probs[: T // 2].max())       # crossed in the first half
    below = probs[probs < target]
    assert target - below.max() > 2e-3, "no margin below the target"
    return (target + float(below.max())) / 2


@pytest.fixture(scope="module")
def full_case():
    jcfg, tcfg, jp, tm = models(jax_cfg("full"), 6)
    thr = _stopping_threshold(tcfg, tm, TEXTS[0])
    return (*_with_stop(jcfg, tcfg, thr), jp, tm)


@pytest.fixture(scope="module")
def local_case():
    # [local, full] with r 2: the ring of kv_local wraps within 16 groups
    jcfg, tcfg, jp, tm = models(jax_cfg("local", ["local", "full"], r=2), 7)
    return (*_with_stop(jcfg, tcfg, 2.0), jp, tm)


@pytest.mark.parametrize("which,mode,texts", [
    ("full", "kv_full", TEXTS[:1]),
    ("local", "kv_local", TEXTS),
])
def test_stream_matches_jax(request, which, mode, texts):
    jcfg, tcfg, jp, tm = request.getfixturevalue(f"{which}_case")
    js = JStream(jcfg, jp, None, max_frames=T, mode=mode)
    want = list(js.stream(texts, chunk_frames=8))
    ss = StreamingSynthesizer(tcfg, tm, None, max_frames=T, mode=mode)
    got = list(ss.stream(texts, chunk_frames=8))
    assert [g.shape for g in got] == [w.shape for w in want]
    assert scaled_err(np.concatenate(got, 1), np.concatenate(want, 1)) <= TOL
    np.testing.assert_array_equal(ss.last_lengths, js.last_lengths)
    if which == "full":     # the stop fired: the tail after it was emitted
        assert ss.last_lengths[0] < T


def _decoded(tcfg, tm, texts, mode="kv_full"):
    """``decode_greedy``'s loop (staged=False, unroll 1), stopped as it
    stops -> the decoder with its frames before the postnet."""
    from rtts_torch.text import encode_batch

    tokens, mask = encode_batch(texts)
    tok, msk = tt(tokens).long(), tt(mask)
    with torch.no_grad():
        mem = TM.encode(tm, tcfg.model, tok, msk)
        dec = TD._Decoder(tm, tcfg.model, mem, msk, T, T, mode,
                          torch.Generator().manual_seed(0),
                          tcfg.model.stop_threshold)
        for t in range(T):
            dec.step(t)
            if bool(dec.done.all()):
                break
    return dec


def test_streamed_mel_matches_full_pipeline(full_case):
    """Chunked decode + windowed postnet = the whole buffer's postnet on
    the emitted region; the frames before the postnet are the step loop's,
    bit for bit."""
    _, tcfg, _, tm = full_case
    ss = StreamingSynthesizer(tcfg, tm, None, max_frames=T)
    streamed = np.concatenate(list(ss.stream(TEXTS[:1], chunk_frames=8)), 1)
    dec = _decoded(tcfg, tm, TEXTS[:1])
    assert torch.equal(ss.last_mel, dec.mel)
    with torch.no_grad():
        full = (dec.mel + postnet_apply(tm.postnet, dec.mel,
                                        torch.float32)).numpy()
    n = streamed.shape[1]
    assert n == min(T, int(dec.lengths.max()) + TST._postnet_context(
        tcfg.model))
    np.testing.assert_allclose(streamed, full[:, :n], atol=1e-4, rtol=1e-3)


def test_streamed_audio_matches_one_vocoder_pass(full_case, vocoder):
    """The vocoder windows with receptive-field context and slices of one
    z give one pass's audio on the same mel and the same z."""
    _, tcfg, _, tm = full_case
    ss = StreamingSynthesizer(tcfg, tm, vocoder, max_frames=T)
    chunks = list(ss.stream(TEXTS, chunk_frames=8, seed=3))
    audio = np.concatenate(chunks, 1)
    hop = VOC.hop_length
    assert all(c.shape[1] > 0 and c.shape[1] % hop == 0 for c in chunks)
    n = audio.shape[1] // hop
    mel_only = StreamingSynthesizer(tcfg, tm, None, max_frames=T)
    mel = np.concatenate(list(mel_only.stream(TEXTS, chunk_frames=8,
                                              seed=3)), 1)[:, :n]
    per_frame = hop // VOC.n_group
    gen = torch.Generator().manual_seed(TST._voc_seed(3))
    z = torch.randn((2, T * per_frame, VOC.n_group), generator=gen) * \
        VOC.sigma
    one = TSW._infer_chunk(vocoder, torch.from_numpy(mel),
                           z[:, :n * per_frame], cfg=VOC).numpy()
    np.testing.assert_allclose(audio, one, atol=1e-3, rtol=1e-2)
    np.testing.assert_array_equal(ss.last_lengths, mel_only.last_lengths)


@pytest.mark.parametrize("frames,kernel", [(48, 3), (23, 3), (23, 4)])
def test_infer_streaming_equals_infer(frames, kernel):
    """Same generator state, so the same z; 23 frames leave a ragged tail;
    an even kernel pads one more on the right (k // 2 covers it)."""
    cfg = dataclasses.replace(VOC, wn_kernel_size=kernel)
    vocoder = _vocoder(cfg)
    mel = torch.randn(2, frames, VOC.n_mels,
                      generator=torch.Generator().manual_seed(frames))
    full = TSW.infer(vocoder, cfg, mel,
                     generator=torch.Generator().manual_seed(1))
    stream = TSW.infer_streaming(vocoder, cfg, mel, chunk_frames=16,
                                 generator=torch.Generator().manual_seed(1))
    assert stream.shape == full.shape == (2, frames * VOC.hop_length)
    np.testing.assert_allclose(stream.numpy(), full.numpy(), atol=1e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("kernel,layers,flows", [(3, 2, 4), (4, 3, 6),
                                                 (5, 8, 12)])
def test_receptive_field_matches_jax(kernel, layers, flows):
    cfg = dataclasses.replace(VOC, wn_kernel_size=kernel, wn_layers=layers,
                              n_flows=flows)
    jcfg = JC.from_dict(JC.SqueezeWaveConfig, TC.to_dict(cfg))
    assert (TSW.receptive_field_squeezed(cfg)
            == JSW.receptive_field_squeezed(jcfg) == flows * layers
            * (kernel // 2))


def test_stream_checks_its_arguments(full_case):
    _, tcfg, _, tm = full_case
    with pytest.raises(ValueError, match="mode"):
        StreamingSynthesizer(tcfg, tm, max_frames=T, mode="nope")
    with pytest.raises(ValueError, match="kv_local"):
        StreamingSynthesizer(tcfg, tm, max_frames=T, mode="kv_local")
    with pytest.raises(ValueError, match="attn_window"):
        StreamingSynthesizer(tcfg, tm, max_frames=T, attn_window=(0, 0))
    with pytest.raises(ValueError, match="positions"):
        StreamingSynthesizer(tcfg, tm, max_frames=1024)
    ss = StreamingSynthesizer(tcfg, tm, max_frames=T)
    assert ss.mode == "kv_full"
    with pytest.raises(ValueError, match="chunk_frames"):
        next(ss.stream(TEXTS, chunk_frames=0))
