"""The port's native C++ data path (``rtts_torch/data/native_loader.py``
over ``rtts_torch/csrc/rtts_native.cc``) against the JAX package's
(``rtts/data/native_loader.py`` over ``native/rtts_native.cc``), both
built here with g++, on the CPU.

Everything is held bit for bit, with the same seeds and numpy inputs:

- ``write_clip`` writes the same bytes; ``wav_read`` (mono and stereo),
  ``resample`` (44.1 -> 22.05 kHz, 16 -> 22.05 kHz, equal rates) and
  ``trim_silence`` return the same samples;
- ``NativeClipLoader.fill_batch`` and ``fill_crops`` equal the JAX
  package's and the port's Python collate and crops;
- ``TextMelDataset.batches`` and ``EpochBatcher.batch_at`` over two epochs
  with ``num_workers`` 2 equal the JAX package's, and the port's own with
  ``num_workers`` 0, also ``batch_at`` from a fresh batcher at a mid-epoch
  step (a resume); ``MelAudioDataset.sample`` likewise;
- ``preprocess_corpus`` with both packages' native branches on (44.1 kHz
  sources, silence padding, a long recording cut by timing) writes equal
  manifests and bit-equal tokens and audio (the log-mel, computed by each
  framework, within ``tests/test_torch_pipeline.py``'s tolerance);
- a source that does not compile leaves ``available()`` False with g++'s
  message in ``build_error()``, and a dataset then takes the Python path
  to the same batches and says why.

Where g++ is present and either library fails to build, the tests fail.
"""

import json
import pathlib
import shutil
import wave

import numpy as np
import pytest

import rtts.config as JC
import rtts_torch.config as TC
from rtts.audio.wav import write_wav
from rtts.data import corpus as JCo
from rtts.data import dataset as JD
from rtts.data import native_loader as JN
from rtts.data import preprocess as JP
from rtts_torch.data import dataset as TD
from rtts_torch.data import native_loader as TN
from rtts_torch.data import preprocess as TP
from tests.test_torch_pipeline import assert_mel_close
from torch_twin import one_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the native library")


@pytest.fixture(scope="module", autouse=True)
def built():
    assert TN.available(), TN.build_error()
    assert JN.available(), JN.build_error()


def _random_clip(rng, n_tokens=17, frames=9, n_mels=5):
    return (rng.integers(0, 60, n_tokens).astype(np.int32),
            rng.standard_normal((frames, n_mels)).astype(np.float32),
            rng.standard_normal(frames * 4).astype(np.float32))


def test_write_clip_bytes_equal(tmp_path):
    clip = _random_clip(np.random.default_rng(0))
    TN.calls.clear()
    TN.write_clip(str(tmp_path / "port.rclip"), *clip)
    JN.write_clip(str(tmp_path / "jax.rclip"), *clip)
    assert TN.calls["write_clip"] == 1          # through the library
    assert (tmp_path / "port.rclip").read_bytes() == \
        (tmp_path / "jax.rclip").read_bytes()
    for got, want in zip(TN.read_clip(str(tmp_path / "port.rclip")), clip):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_read_equal(tmp_path, channels):
    pcm = np.random.default_rng(channels).integers(
        -32768, 32768, (3001, channels)).astype("<i2")
    path = tmp_path / "x.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    got, got_sr = TN.wav_read(str(path))
    want, want_sr = JN.wav_read(str(path))
    assert got_sr == want_sr == 16000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rates", [(44100, 22050), (16000, 22050),
                                   (22050, 22050)])
def test_resample_equal(rates):
    x = np.random.default_rng(1).uniform(-0.5, 0.5, 4410).astype(np.float32)
    got, want = TN.resample(x, *rates), JN.resample(x, *rates)
    assert got.dtype == np.float32 and len(got) == len(x) * rates[1] // rates[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("threshold_db", [-40.0, -20.0])
def test_trim_silence_equal(threshold_db):
    sr = 22050
    rng = np.random.default_rng(2)
    sig = np.concatenate([
        1e-4 * rng.standard_normal(sr // 5),
        0.5 * np.sin(np.linspace(0, 600 * np.pi, sr // 2)),
        1e-4 * rng.standard_normal(sr // 3)]).astype(np.float32)
    got = TN.trim_silence(sig, sr, threshold_db)
    want = JN.trim_silence(sig, sr, threshold_db)
    assert sr // 4 < len(got) < len(sig)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Ten clips preprocessed by the JAX package (its native branch), and
    the dataset config both packages read them with."""
    root = tmp_path_factory.mktemp("native_corpus")
    JCo.generate_corpus(root, 10, 22050)
    cfg = JC.DatasetConfig(data_dir=str(root / "data"), val_fraction=0.2,
                           num_workers=0)
    JP.preprocess_corpus(cfg, str(root / "transcripts.txt"))
    return cfg


def _configs(corpus, workers):
    data = dict(JC.to_dict(corpus), num_workers=workers)
    return (JC.from_dict(JC.DatasetConfig, data),
            TC.from_dict(TC.DatasetConfig, data))


def _manifests(corpus):
    path = pathlib.Path(corpus.data_dir) / corpus.manifest
    return JD.Manifest.load(path), TD.Manifest.load(path)


def _equal_batches(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_fill_batch_and_crops_equal(corpus):
    jman, tman = _manifests(corpus)
    paths = [c["clip"] for c in tman.clips]
    tl, jl = TN.NativeClipLoader(paths, 2), JN.NativeClipLoader(paths, 2)
    _, tcfg = _configs(corpus, 0)
    python = TD.TextMelDataset(tman, tcfg)
    TN.calls.clear()
    for chunk in ([0, 3, 5], [9], [1, 2, 4, 6, 7, 8]):
        tl.prefetch(chunk)
        jl.prefetch(chunk)
        t_pad, m_pad = python._bucket_shape_from_manifest(chunk)
        got = tl.fill_batch(chunk, t_pad, m_pad, tman.n_mels)
        _equal_batches(got, jl.fill_batch(chunk, t_pad, m_pad, jman.n_mels))
        _equal_batches(got, python.collate([python[i] for i in chunk]))
    hop, frames = tman.hop_length, 8
    picks = [0, 4, 4, 9]
    offsets = [0, 3, tman.clips[4]["n_frames"] - frames, 1]
    got = tl.fill_crops(picks, offsets, frames, hop, tman.n_mels)
    _equal_batches(got, jl.fill_crops(picks, offsets, frames, hop,
                                      jman.n_mels))
    for r, (p, f0) in enumerate(zip(picks, offsets)):
        _, mel, audio = TN.read_clip(paths[p])
        np.testing.assert_array_equal(got["mel"][r], mel[f0:f0 + frames])
        np.testing.assert_array_equal(
            got["audio"][r], audio[f0 * hop:(f0 + frames) * hop])
    assert (TN.calls["fill_batch"], TN.calls["fill_crops"],
            TN.calls["prefetch"]) == (3, 1, 3)
    with pytest.raises(IOError, match="rc=-2"):
        tl.fill_crops([0], [tman.clips[0]["n_frames"]], frames, hop,
                      tman.n_mels)


def test_text_mel_batches_equal_jax_and_python(corpus):
    jman, tman = _manifests(corpus)
    jcfg, tcfg = _configs(corpus, 2)
    jsplit = JD.split_manifest(jman, corpus.val_fraction, 3)
    tsplit = TD.split_manifest(tman, corpus.val_fraction, 3)
    jds = JD.TextMelDataset(jsplit[0], jcfg)
    native = TD.TextMelDataset(tsplit[0], tcfg)
    python = TD.TextMelDataset(tsplit[0], _configs(corpus, 0)[1])
    assert native.loader_path == "native" and python.loader_path == "python"
    assert "2 C++ worker threads" in native.loader_reason
    assert "num_workers is 0" in python.loader_reason
    assert jds._native_loader() is not None
    TN.calls.clear()
    runs = [list(ds.batches(3, seed=1, loop=False)) for ds in (native, jds,
                                                               python)]
    assert len(runs[0]) == 3 and TN.calls["fill_batch"] == 3
    for got, jax_b, py_b in zip(*runs):
        _equal_batches(got, jax_b)
        _equal_batches(got, py_b)
    batchers = [JD.EpochBatcher(jds, 3, seed=5, drop_last=True)] + [
        TD.EpochBatcher(ds, 3, seed=5, drop_last=True)
        for ds in (native, python)]
    n = batchers[0].steps_per_epoch()
    assert n == 2
    for step in range(2 * n):
        want = batchers[0].batch_at(step)
        for b in batchers[1:]:
            _equal_batches(b.batch_at(step), want)
    # a resume: a fresh dataset and batcher start at a mid-epoch step
    fresh = TD.EpochBatcher(TD.TextMelDataset(tsplit[0], tcfg), 3, seed=5,
                            drop_last=True)
    for step in (n + 1, 1):
        _equal_batches(fresh.batch_at(step), batchers[0].batch_at(step))


def test_mel_audio_sample_equal_jax_and_python(corpus):
    jman, tman = _manifests(corpus)
    jcfg, tcfg = _configs(corpus, 2)
    seg = tman.hop_length * (min(c["n_frames"] for c in tman.clips) // 2)
    jds = JD.MelAudioDataset(jman, jcfg, seg)
    native = TD.MelAudioDataset(tman, tcfg, seg)
    python = TD.MelAudioDataset(tman, _configs(corpus, 0)[1], seg)
    assert native.loader_path == "native" and python.loader_path == "python"
    TN.calls.clear()
    for seed in (0, (3, 7)):
        rngs = [np.random.default_rng(seed) for _ in range(3)]
        for bsz in (4, 1):
            got = native.sample(rngs[0], bsz)
            _equal_batches(got, jds.sample(rngs[1], bsz))
            _equal_batches(got, python.sample(rngs[2], bsz))
            assert got["audio"].shape == (bsz, seg)
    assert TN.calls["fill_crops"] == 4


@pytest.fixture(scope="module")
def source_44k(tmp_path_factory):
    """Four utterances at 44.1 kHz, each padded with quiet noise at both
    ends, and a long 44.1 kHz recording cut by transcript timing."""
    root = tmp_path_factory.mktemp("native_44k")
    JCo.generate_corpus(root, 4, 44100)
    rng = np.random.default_rng(4)
    for i, wav in enumerate(sorted((root / "wavs").glob("*.wav"))):
        audio, _ = JN.wav_read(str(wav))
        pad = [(3e-4 * rng.standard_normal(n)).astype(np.float32)
               for n in (4410 + 997 * i, 8820 - 631 * i)]
        write_wav(wav, np.concatenate([pad[0], audio, pad[1]]), 44100)
    JCo.generate_long_recording(root, 2, 44100)
    return root


@pytest.mark.parametrize("transcripts", ["transcripts.txt",
                                         "transcripts_timed.txt"])
def test_preprocess_native_equals_jax_native(source_44k, transcripts,
                                             tmp_path):
    tpath = str(source_44k / transcripts)
    out = {}
    TN.calls.clear()
    out["jax"] = JP.preprocess_corpus(
        JC.DatasetConfig(data_dir=str(tmp_path / "jax")), tpath)
    out["port"] = TP.preprocess_corpus(
        TC.DatasetConfig(data_dir=str(tmp_path / "port")), tpath,
        device="cpu")
    n = 4 if transcripts == "transcripts.txt" else 2
    reads = 4 if n == 4 else 1
    assert {k: TN.calls[k] for k in ("wav_read", "resample", "trim_silence",
                                     "write_clip")} == {
        "wav_read": reads, "resample": reads, "trim_silence": n,
        "write_clip": n}
    mans = {}
    for tag, path in out.items():
        with open(path) as f:
            man = json.load(f)
        root = str(tmp_path / tag)
        mans[tag] = dict(man, clips=[dict(c, clip=c["clip"][len(root):])
                                     for c in man["clips"]])
    assert mans["port"] == mans["jax"] and len(mans["jax"]["clips"]) == n
    for c in mans["jax"]["clips"]:
        got = TN.read_clip(str(tmp_path / "port") + c["clip"])
        want = TN.read_clip(str(tmp_path / "jax") + c["clip"])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[1].shape == want[1].shape
        assert_mel_close(got[1], want[1])


def test_failed_build_is_reported_and_python_takes_over(corpus, tmp_path,
                                                        monkeypatch):
    broken = tmp_path / "broken.cc"
    broken.write_text("int rtts_loader_create( {\n")
    monkeypatch.setattr(TN, "SRC", broken)
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_build_error", None)
    monkeypatch.setattr(TD, "_said", set())
    assert not TN.available()
    assert "g++ failed" in TN.build_error() and "broken.cc" in \
        TN.build_error()
    assert not list((tmp_path / "build").glob("*.so"))
    with pytest.raises(RuntimeError, match="native library unavailable"):
        TN.resample(np.zeros(8, np.float32), 2, 1)
    _, tman = _manifests(corpus)
    _, tcfg = _configs(corpus, 2)
    ds = TD.TextMelDataset(tman, tcfg)
    assert ds.loader_path == "python"
    assert "did not build" in ds.loader_reason and "g++ failed" in \
        ds.loader_reason
    python = TD.TextMelDataset(tman, _configs(corpus, 0)[1])
    for got, want in zip(ds.batches(4, seed=2), python.batches(4, seed=2)):
        _equal_batches(got, want)
    # the Python writer writes the library's bytes
    clip = _random_clip(np.random.default_rng(5))
    TN.write_clip(str(tmp_path / "py.rclip"), *clip)
    JN.write_clip(str(tmp_path / "jax.rclip"), *clip)
    assert (tmp_path / "py.rclip").read_bytes() == \
        (tmp_path / "jax.rclip").read_bytes()
