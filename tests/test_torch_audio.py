"""The port's audio frontend, Griffin-Lim and denoiser against rtts (JAX),
on the CPU.

The same numpy signals go through ``rtts.audio`` / ``rtts.infer.denoiser``
and their counterparts in ``rtts_torch``.  The filterbank is a numpy copy
and is held exactly.  Transforms (float32, JAX's matmuls at "highest"
precision, tests/conftest.py) are held to 1e-5 of the largest entry of the
reference's output (summation order of a length-1024 product); Griffin-Lim
and the denoiser, whose phase normalization and overlap-add compound that
rounding over iterations, to 1e-4.  JAX draws Griffin-Lim's initial phase
with ``jax.random``, which torch cannot reproduce: the port's
``_griffin_lim_from_angle`` is fed the JAX angle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtts.audio import griffin as JG
from rtts.audio import stft as JS
from rtts.config import AudioConfig
from rtts.infer import denoiser as JD
from rtts.models import squeezewave as JSW
from rtts_torch.audio import griffin as TG
from rtts_torch.audio import stft as TS
from rtts_torch.config import AudioConfig as TAudioConfig
from rtts_torch.convert import from_numpy_tree
from rtts_torch.infer import denoiser as TD
from rtts_torch.models import squeezewave as TSW
from tests.test_full_model_parity import vocoder_cfg
from torch_twin import one_thread  # noqa: F401  (autouse)


TOL = 1e-5
GL_TOL = 1e-4


def scaled_close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1.0))


def _signal(n, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    shape = (n,) if batch is None else (batch, n)
    tone = 0.5 * np.sin(2 * np.pi * 220.0 * t) + 0.2 * np.sin(
        2 * np.pi * 1375.0 * t)
    return (tone + 0.05 * rng.standard_normal(shape)).astype(np.float32)


def _port_cfg(cfg: AudioConfig) -> TAudioConfig:
    return TAudioConfig(**dataclasses.asdict(cfg))


def test_mel_scale_and_filterbank_equal():
    f = np.array([0.0, 440.0, 999.9, 1000.0, 4000.0, 11025.0])
    np.testing.assert_array_equal(TS.hz_to_mel(f), JS.hz_to_mel(f))
    m = JS.hz_to_mel(f)
    np.testing.assert_array_equal(TS.mel_to_hz(m), JS.mel_to_hz(m))
    for args in ((22050, 1024, 80, 0.0, 8000.0), (16000, 512, 40, 50.0, None)):
        np.testing.assert_array_equal(TS.mel_filterbank(*args),
                                      JS.mel_filterbank(*args))
    np.testing.assert_array_equal(TS._hann(1024), JS._hann(1024))


@pytest.mark.parametrize("method", ["matmul", "fft"])
@pytest.mark.parametrize("center,win", [(True, 1024), (False, 800)])
def test_stft_magnitude_matches_jax(method, center, win):
    x = _signal(5000, batch=2)
    want = JS.stft_magnitude(jnp.asarray(x), 1024, 256, win, center, method)
    got = TS.stft_magnitude(torch.from_numpy(x), 1024, 256, win, center,
                            method)
    assert got.shape == want.shape
    scaled_close(got, want)


def test_frame_reflects_as_numpy_on_a_short_signal():
    """A signal shorter than the reflect pad: the index grid folds it as
    numpy's (and jnp's) reflect padding does."""
    x = _signal(300)
    want = JS._frame(jnp.asarray(x), 1024, 256, True)
    got = TS._frame(torch.from_numpy(x), 1024, 256, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["matmul", "fft"])
def test_log_mel_matches_jax(method):
    cfg = AudioConfig()
    x = _signal(8192, seed=1, batch=2)
    want = JS.log_mel_spectrogram(jnp.asarray(x), cfg, method=method)
    got = TS.log_mel_spectrogram(torch.from_numpy(x), _port_cfg(cfg),
                                 method=method)
    assert got.shape == want.shape == (2, 8192 // 256 + 1, cfg.n_mels)
    # log-mels: held against the whole log range, floor included
    scaled_close(got, want, 1e-4)
    np.testing.assert_array_equal(
        TS.make_mel_fn(_port_cfg(cfg), method)(torch.from_numpy(x)).numpy(),
        got.numpy())


def _complex_spec(frames, seed=2):
    rng = np.random.default_rng(seed)
    mag = np.abs(rng.standard_normal((frames, 513))).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (frames, 513)).astype(np.float32)
    return mag, ang


def test_istft_matches_jax():
    mag, ang = _complex_spec(20)
    spec = mag * np.exp(1j * ang).astype(np.complex64)
    want = JG.istft(jnp.asarray(spec), 1024, 256)
    got = TG.istft(torch.from_numpy(spec), 1024, 256)
    assert got.shape == (20 * 256,)
    scaled_close(got, want)


def test_griffin_lim_from_the_jax_angle_matches_jax():
    mag, _ = _complex_spec(24, seed=3)
    want = JG.griffin_lim(jnp.asarray(mag), 1024, 256, n_iter=6, seed=5)
    angle = jax.random.uniform(jax.random.PRNGKey(5), mag.shape,
                               minval=-np.pi, maxval=np.pi)
    got = TG._griffin_lim_from_angle(torch.from_numpy(mag),
                                     torch.from_numpy(np.array(angle)),
                                     1024, 256, 6)
    assert got.shape == (24 * 256,)
    scaled_close(got, want, GL_TOL)


def test_griffin_lim_draws_its_phase_from_the_seed():
    mag = torch.from_numpy(_complex_spec(8, seed=4)[0])
    a, b = (TG.griffin_lim(mag, 1024, 256, n_iter=2, seed=7) for _ in range(2))
    c = TG.griffin_lim(mag, 1024, 256, n_iter=2, seed=8)
    assert a.shape == (8 * 256,) and bool(torch.isfinite(a).all())
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_mel_to_audio_matches_jax(monkeypatch):
    """pinv(filterbank) magnitude + Griffin-Lim at the default 32
    iterations, with the JAX initial phase handed to the port."""
    cfg = AudioConfig()
    log_mel = np.asarray(JS.log_mel_spectrogram(jnp.asarray(_signal(4096)),
                                                cfg))
    want = JG.mel_to_audio(jnp.asarray(log_mel), cfg)

    def jax_phase(magnitude, n_fft, hop, n_iter=32, seed=0):
        angle = jax.random.uniform(jax.random.PRNGKey(seed), magnitude.shape,
                                   minval=-np.pi, maxval=np.pi)
        return TG._griffin_lim_from_angle(
            magnitude, torch.from_numpy(np.array(angle)), n_fft, hop,
            n_iter)

    monkeypatch.setattr(TG, "griffin_lim", jax_phase)
    got = TG.mel_to_audio(torch.from_numpy(log_mel), _port_cfg(cfg))
    assert got.shape == (log_mel.shape[0] * cfg.hop_length,)
    scaled_close(got, want, GL_TOL)


@pytest.fixture(scope="module")
def vocoder():
    """The tiny vocoder of tests/test_full_model_parity.py, "end" live."""
    cfg = vocoder_cfg()
    @jax.jit
    def init(key):
        jp = JSW.init(key, cfg)
        for i, flow in enumerate(jp["flows"]):
            k = jax.random.fold_in(jax.random.PRNGKey(2), i)
            flow["wn"]["end"]["w"] = 0.05 * jax.random.normal(
                k, flow["wn"]["end"]["w"].shape)
        return jp

    jp = init(jax.random.PRNGKey(1))
    tm = from_numpy_tree(TSW.init(cfg, device="cpu"),
                         jax.tree.map(np.asarray, jp))
    return cfg, jp, tm


def test_bias_spectrum_and_denoise_match_jax(vocoder):
    cfg, jp, tm = vocoder
    want_bias = jax.jit(lambda p: JD.estimate_bias_spectrum(p, cfg))(jp)
    got_bias = TD.estimate_bias_spectrum(tm, cfg)
    assert got_bias.shape == (513,)
    scaled_close(got_bias, want_bias, GL_TOL)
    audio = _signal(6000, seed=5)
    want = jax.jit(lambda a, b: JD.denoise(a, b, 0.3))(jnp.asarray(audio),
                                                      want_bias)
    got = TD.denoise(torch.from_numpy(audio), torch.from_numpy(
        np.array(want_bias)), 0.3)
    assert got.shape == (6000,)
    scaled_close(got, want, GL_TOL)
    # the wrapper: numpy in, numpy out, on the vocoder's device
    out = TD.Denoiser(TSW.fold_weightnorm(tm), cfg, strength=0.3)(audio)
    assert isinstance(out, np.ndarray) and out.shape == audio.shape
    scaled_close(out, want, GL_TOL)


def test_synthesizer_without_a_vocoder_uses_griffin_lim():
    from rtts_torch.config import Config, from_dict
    from rtts_torch.infer.synthesize import Synthesizer
    from rtts_torch.models import reformer_tts as M
    from rtts_torch.text import frontend_vocab_size

    att = {"kind": "auto", "num_heads": 2, "head_dim": 16}
    stack = {"num_layers": 1, "d_model": 32, "d_ff": 64, "attention": att}
    cfg = from_dict(Config, {
        "model": {"vocab_size": frontend_vocab_size(), "d_model": 32,
                  "n_mels": 80, "encoder": dict(stack, causal=False),
                  "decoder": dict(stack, causal=True),
                  "dec_prenet_hidden": 16, "postnet_channels": 16,
                  "max_pos": 64}})
    syn = Synthesizer(cfg, M.init(cfg.model, torch.Generator().manual_seed(0),
                                  "cpu"), max_frames=16)
    mel, lengths = syn.text_to_mel(["hello world", "gl"])
    wavs = syn(["hello world", "gl"])
    hop = cfg.dataset.audio.hop_length
    assert [len(w) for w in wavs] == [hop * int(n) for n in lengths]
    assert all(np.isfinite(w).all() for w in wavs)
    want = TG.mel_to_audio(torch.from_numpy(mel[0, :lengths[0]]),
                           cfg.dataset.audio)
    np.testing.assert_array_equal(wavs[0], want.numpy())
