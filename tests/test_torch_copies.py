"""The port's own copies of the JAX package's framework-free modules, held
equal to the originals on the CPU.

``rtts_torch`` imports nothing of ``rtts``, so it keeps copies of what it
uses: the configuration tree (``rtts_torch/config.py``), the text frontend
(``rtts_torch/text/``), the TTS and vocoder data pipeline
(``rtts_torch/data.py``), the metric logger (``rtts_torch/utils/metrics.py``),
wav IO and resampling (``rtts_torch/audio/``), the host-side quality
scalars (``rtts_torch/train/quality.py``) and the eval images
(``rtts_torch/utils/visualize.py``).  Each must behave as its
original: the same config from the same YAML, the same token ids, the same
batches and crops, the same JSONL lines, files, samples and scalars.
"""

import dataclasses
import json
import pathlib
import typing

import numpy as np
import pytest

import rtts.config as JC
import rtts.text as JT
import rtts_torch.config as TC
import rtts_torch.text as TT
from rtts.audio import resample as JR
from rtts.audio import wav as JW
from rtts.data import dataset as JD
from rtts.train import quality as JQ
from rtts.utils.metrics import MetricLogger as JaxLogger
from rtts_torch import data as TD
from rtts_torch.audio import resample as TR
from rtts_torch.audio import wav as TW
from rtts_torch.train import quality as TQ
from rtts_torch.utils.metrics import MetricLogger as PortLogger

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_every_config_resolves_alike(path):
    data = JC.load_yaml(path)
    assert TC.load_yaml(path) == data
    assert TC.to_dict(TC.from_dict(TC.Config, data)) == \
        JC.to_dict(JC.from_dict(JC.Config, data))
    for over in (["model.encoder.attention.num_hashes=2"],
                 ["model.decoder.attention.num_buckets=[4, 8]"]):
        assert TC.apply_overrides(data, over) == JC.apply_overrides(data, over)


def _dataclasses(module):
    return {name: obj for name, obj in vars(module).items()
            if dataclasses.is_dataclass(obj) and obj.__module__ == module.__name__}


def test_dataclass_fields_and_defaults_equal():
    jax_classes, port_classes = _dataclasses(JC), _dataclasses(TC)
    assert sorted(port_classes) == sorted(jax_classes)
    for name, jcls in jax_classes.items():
        tcls = port_classes[name]
        jf, tf = dataclasses.fields(jcls), dataclasses.fields(tcls)
        assert [f.name for f in tf] == [f.name for f in jf], name
        hints = [str(typing.get_type_hints(tcls)[f.name]).replace(
            "rtts_torch.config", "rtts.config") for f in tf]
        assert hints == [str(typing.get_type_hints(jcls)[f.name])
                         for f in jf], name
    assert TC.to_dict(TC.Config()) == JC.to_dict(JC.Config())
    assert TC.AUTO_FFN_CHUNK == JC.AUTO_FFN_CHUNK
    with pytest.raises(KeyError, match="unknown config keys"):
        TC.from_dict(TC.Config, {"model": {"d_modle": 3}})


def test_attention_kind_resolution_equal():
    for kw in ({}, {"kind": "auto"}, {"kind": "auto", "flash": False},
               {"kind": "auto", "auto_full_max_len": 100}):
        for seq_len in (64, 100, 4096, 8192, 40000):
            assert TC.resolve_attention_kind(TC.AttentionConfig(**kw), seq_len) \
                == JC.resolve_attention_kind(JC.AttentionConfig(**kw), seq_len)


SENTENCES = ["The quick brown fox jumps over the lazy dog.", "",
             "Dr. Smith paid $42.50 on 3/14 at 10am!", "naïve café — Ünïcödé 🙂",
             "HH AH0 L OW1 .", "   spaces   and\ttabs\n"]


@pytest.mark.parametrize("level", ["char", "phoneme"])
@pytest.mark.parametrize("pad", [1, 64])
def test_encode_batch_equal(level, pad):
    want = JT.encode_batch(SENTENCES, pad_to_multiple=pad, level=level)
    got = TT.encode_batch(SENTENCES, pad_to_multiple=pad, level=level)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert TT.frontend_vocab_size(level) == JT.frontend_vocab_size(level)
    assert TT.SYMBOLS == JT.SYMBOLS and TT.PHONEME_SYMBOLS == JT.PHONEME_SYMBOLS
    for text in SENTENCES:
        assert TT.clean_text(text) == JT.clean_text(text)
        assert TT.ids_to_text(TT.text_to_ids(text)) == \
            JT.ids_to_text(JT.text_to_ids(text))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from rtts.data.corpus import generate_corpus
    from rtts.data.preprocess import preprocess_corpus

    root = tmp_path_factory.mktemp("copies_corpus")
    generate_corpus(root, n_utterances=10)
    cfg = JC.DatasetConfig(data_dir=str(root / "data"), val_fraction=0.3,
                           num_workers=0)
    preprocess_corpus(cfg, str(root / "transcripts.txt"))
    return cfg


def _equal_batches(a, b):
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_datasets_batch_alike(corpus):
    path = pathlib.Path(corpus.data_dir) / corpus.manifest
    jman, tman = JD.Manifest.load(path), TD.Manifest.load(path)
    assert tman == TD.Manifest(jman.sample_rate, jman.hop_length, jman.n_mels,
                               jman.clips)
    jsplit = JD.split_manifest(jman, corpus.val_fraction, 3)
    tsplit = TD.split_manifest(tman, corpus.val_fraction, 3)
    assert [m.clips for m in tsplit] == [m.clips for m in jsplit]
    tcfg = TC.from_dict(TC.DatasetConfig, JC.to_dict(corpus))
    jds, tds = JD.TextMelDataset(jsplit[0], corpus), TD.TextMelDataset(tsplit[0],
                                                                       tcfg)
    for i in range(len(jds)):
        for g, w in zip(tds[i], jds[i]):
            np.testing.assert_array_equal(g, w)
    jb = JD.EpochBatcher(jds, 3, seed=5, drop_last=True)
    tb = TD.EpochBatcher(tds, 3, seed=5, drop_last=True)
    assert tb.steps_per_epoch() == jb.steps_per_epoch()
    for step in range(2 * jb.steps_per_epoch() + 1):
        _equal_batches(tb.batch_at(step), jb.batch_at(step))
    for got, want in zip(tds.batches(2, seed=1), jds.batches(2, seed=1)):
        _equal_batches(got, want)


def test_metric_loggers_write_alike(tmp_path, monkeypatch):
    monkeypatch.setattr("time.time", lambda: 1234.5)
    for cls, name in ((JaxLogger, "jax.jsonl"), (PortLogger, "port.jsonl")):
        logger = cls(str(tmp_path / name), echo=False)
        logger.log(3, {"loss": np.float32(1.5), "note": "x", "n": 2},
                   prefix="train/")
        logger.log(4, {"mcd": 7.25})
        logger.close()
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "jax.jsonl").read_text()
    lines = [json.loads(l) for l in (tmp_path / "port.jsonl").open()]
    assert lines[0] == {"step": 3, "time": 1234.5, "train/loss": 1.5,
                        "train/note": "x", "train/n": 2.0}


def test_vocoder_datasets_crop_alike(corpus):
    """``MelAudioDataset.sample``: the same picks, offsets and crops from
    the same generator, bit for bit, and the same refusals."""
    path = pathlib.Path(corpus.data_dir) / corpus.manifest
    jman, tman = JD.Manifest.load(path), TD.Manifest.load(path)
    hop = jman.hop_length
    seg = hop * min(c["n_frames"] for c in jman.clips) // 2 * 2
    jds = JD.MelAudioDataset(jman, corpus, seg)
    tds = TD.MelAudioDataset(tman, seg)
    assert [c["clip"] for c in tds.usable] == [c["clip"] for c in jds.usable]
    for seed in (0, (3, 7)):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        for bsz in (4, 1, 3):
            got, want = tds.sample(tr, bsz), jds.sample(jr, bsz)
            _equal_batches(got, want)
            assert got["audio"].shape == (bsz, seg)
            assert got["mel"].shape == (bsz, seg // hop, jman.n_mels)
    longest = max(c["n_samples"] for c in jman.clips)
    for bad in (hop + 1, hop * (longest // hop + 1)):
        with pytest.raises(ValueError) as want:
            JD.MelAudioDataset(jman, corpus, bad)
        with pytest.raises(ValueError, match=str(want.value)):
            TD.MelAudioDataset(tman, bad)


@pytest.mark.parametrize("width", [1, 2, 4])
def test_wav_io_alike(tmp_path, width):
    """Each package reads what the other writes, to the same samples; the
    writers give the same bytes; 8/16/32-bit stereo files read alike."""
    import wave

    x = np.clip(np.random.default_rng(0).standard_normal(999) * 0.4,
                -1.2, 1.2).astype(np.float32)
    TW.write_wav(tmp_path / "t" / "port.wav", x, 22050)
    JW.write_wav(tmp_path / "j" / "jax.wav", x, 22050)
    assert (tmp_path / "t" / "port.wav").read_bytes() == \
        (tmp_path / "j" / "jax.wav").read_bytes()
    for path in (tmp_path / "t" / "port.wav", tmp_path / "j" / "jax.wav"):
        (a, sr_a), (b, sr_b) = TW.read_wav(path), JW.read_wav(path)
        np.testing.assert_array_equal(a, b)
        assert sr_a == sr_b == 22050
    raw = np.random.default_rng(width).integers(0, 256, 2 * width * 64,
                                                dtype=np.uint8)
    with wave.open(str(tmp_path / "stereo.wav"), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(width)
        w.setframerate(16000)
        w.writeframes(raw.tobytes())
    (a, sr_a), (b, sr_b) = (m.read_wav(tmp_path / "stereo.wav")
                            for m in (TW, JW))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (64,) and sr_a == sr_b == 16000


# small up/down factors: a 16 kHz -> 22.05 kHz pair (up 441, down 320)
# makes np.convolve run 1e10 multiply-adds per call
@pytest.mark.parametrize("rates", [(16000, 24000), (48000, 16000),
                                   (22050, 22050)])
def test_resample_alike(rates):
    x = np.random.default_rng(1).standard_normal(2000).astype(np.float32)
    got, want = TR.resample_poly(x, *rates), JR.resample_poly(x, *rates)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_waveform_quality_scalars_alike():
    rng = np.random.default_rng(2)
    true = rng.standard_normal(9000)
    pred = true + 0.3 * rng.standard_normal(9000)
    np.testing.assert_array_equal(TQ._stft_mag(pred, 512, 128, 240),
                                  JQ._stft_mag(pred, 512, 128, 240))
    assert TQ._stft_mag(pred[:100], 512, 128, 240).shape == (0, 257)
    for p, t in ((pred, true), (pred[:1500], true), (true, true),
                 (pred[:100], true[:100])):
        got = TQ.multi_resolution_stft_distance(p, t)
        want = JQ.multi_resolution_stft_distance(p, t)
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(list(got.values()),
                                      list(want.values()))


def test_attention_diagonality_alike():
    rng = np.random.default_rng(3)
    align = rng.random((40, 30))
    align /= align.sum(1, keepdims=True)
    for args in ((40, 30), (25, 12), (1, 1), (0, 5), (40, 30, 0.3)):
        assert TQ.attention_diagonality(align, *args) == \
            JQ.attention_diagonality(align, *args)


def test_visualize_copy_draws_alike(tmp_path):
    """``rtts_torch/utils/visualize.py``: the original's code after its
    docstring (matplotlib imported inside each function), and the same
    pixels."""
    import matplotlib.image as mpimg

    from rtts.data import visualize as JV
    from rtts_torch.utils import visualize as TV

    def body(module):
        text = pathlib.Path(module.__file__).read_text()
        return text[text.index('"""', 3) + 3:]

    assert body(TV) == body(JV)
    rng = np.random.default_rng(3)
    mel, target = rng.standard_normal((2, 40, 20))
    attn = rng.random((12, 9))
    for module, tag in ((JV, "jax"), (TV, "port")):
        module.plot_spectrogram(mel, str(tmp_path / tag / "mel.png"),
                                target=target)
        module.plot_attention(attn, str(tmp_path / tag / "attn.png"))
    for name in ("mel.png", "attn.png"):
        np.testing.assert_array_equal(mpimg.imread(tmp_path / "jax" / name),
                                      mpimg.imread(tmp_path / "port" / name))
