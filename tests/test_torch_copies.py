"""The port's own copies of the JAX package's framework-free modules, held
equal to the originals on the CPU.

``rtts_torch`` imports nothing of ``rtts``, so it keeps copies of what it
uses: the configuration tree (``rtts_torch/config.py``), the text frontend
(``rtts_torch/text/``), the TTS and vocoder data pipeline
(``rtts_torch/data/dataset.py``), the metric logger
(``rtts_torch/utils/metrics.py``), wav IO and resampling
(``rtts_torch/audio/``), the host-side quality scalars
(``rtts_torch/train/quality.py``), the eval images
(``rtts_torch/utils/visualize.py``), the synthetic corpus
(``rtts_torch/data/corpus.py``), the scraper's parsers
(``rtts_torch/data/download.py``), artifact versioning
(``rtts_torch/data/versioning.py``), the tracker adapters
(``rtts_torch/utils/tracking.py``), preprocessing's silence trim and
transcript parser (``rtts_torch/data/preprocess.py``), and the
framework-free rules of ``rtts/parallel/``: ``should_initialize``,
``param_sharding_rules`` and ``_zero_extend`` (``rtts_torch/parallel/``,
a tuple of dims or None where the original returns a PartitionSpec).
Each must behave as its original: the same config from the same YAML, the
same token ids, the same batches and crops, the same JSONL lines, files,
samples and scalars, the same corpus bytes, parsed pages, lock files and
tracker calls, the same shardings and the same decision to start.
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
from torch_twin import one_thread  # noqa: F401  (autouse)


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
    tcfg = TC.from_dict(TC.DatasetConfig, JC.to_dict(corpus))
    jds = JD.MelAudioDataset(jman, corpus, seg)
    tds = TD.MelAudioDataset(tman, tcfg, seg)
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
            TD.MelAudioDataset(tman, tcfg, bad)


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


def _tree_digest(root: pathlib.Path) -> dict:
    import hashlib

    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("long_recording", [False, True],
                         ids=["corpus", "long_recording"])
def test_corpus_bytes_alike(tmp_path, long_recording):
    from rtts.data import corpus as JCo
    from rtts_torch.data import corpus as TCo

    for i in (0, 5, 23, 24, 25, 999, 20000):
        assert TCo.sentence_for_index(i) == JCo.sentence_for_index(i)
    text = TT.clean_text(TCo.sentence_for_index(30))
    np.testing.assert_array_equal(TCo.synth_utterance(text, 16000),
                                  JCo.synth_utterance(text, 16000))
    for module, tag in ((JCo, "jax"), (TCo, "port")):
        if long_recording:
            module.generate_long_recording(tmp_path / tag, 3, 16000)
        else:
            module.generate_corpus(tmp_path / tag, 3, 16000)
    digest = _tree_digest(tmp_path / "port")
    assert digest == _tree_digest(tmp_path / "jax")
    assert len(digest) == (2 if long_recording else 4)


SCRAPE = ROOT / "tests" / "fixtures" / "scrape"
SCRAPE_BASE = "https://transcripts.example.com/blog/transcripts?page=1"


@pytest.mark.parametrize("page", sorted(p.name for p in SCRAPE.glob("*.html")))
def test_scrape_parsers_alike(page, tmp_path):
    from rtts.data import download as JDl
    from rtts_torch.data import download as TDl

    html = (SCRAPE / page).read_bytes()
    for base in (SCRAPE_BASE, None):
        assert TDl.parse_transcript_index(html, base) == \
            JDl.parse_transcript_index(html, base)
        assert TDl.parse_media_url(html, base) == \
            JDl.parse_media_url(html, base)
        got = TDl.parse_transcript_page(html, "doc000_", base)
        want = JDl.parse_transcript_page(html, "doc000_", base)
        assert [dataclasses.asdict(e) for e in got] == \
            [dataclasses.asdict(e) for e in want]
    TDl.write_transcripts(got, tmp_path / "port.txt")
    JDl.write_transcripts(want, tmp_path / "jax.txt")
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()


def test_versioning_alike(tmp_path):
    from rtts.data import versioning as JV
    from rtts_torch.data import versioning as TV

    data = tmp_path / "data"
    for name, text in (("a.txt", "alpha"), ("sub/b.txt", "beta"),
                       ("sub/c.bin", "gamma" * 1000)):
        (data / name).parent.mkdir(parents=True, exist_ok=True)
        (data / name).write_text(text)
    for module, tag in ((JV, "jax"), (TV, "port")):
        module.snapshot([str(data), str(data / "a.txt")],
                        str(tmp_path / f"{tag}.lock"))
    assert (tmp_path / "port.lock").read_text() == \
        (tmp_path / "jax.lock").read_text()
    lock = str(tmp_path / "port.lock")
    results = {}
    for module, tag in ((JV, "jax"), (TV, "port")):
        remote = tmp_path / f"remote_{tag}"
        first = module.push(lock, str(remote))
        again = module.push(lock, f"file://{remote}")
        (data / "a.txt").write_text("ALPHA CHANGED")
        (data / "sub" / "b.txt").unlink()
        before = module.status(lock)
        pulled = module.pull(lock, str(remote))
        results[tag] = (first, again, before, pulled, module.status(lock),
                        _tree_digest(remote))
    assert results["port"] == results["jax"]
    assert results["port"][3] == (2, [])
    with pytest.raises(RuntimeError, match="no transport registered"):
        TV.push(lock, "s3://bucket/x")


class _FakeTracker:
    def __init__(self, run_name, config=None):
        self.calls = [("init", run_name, config)]

    def log(self, step, metrics):
        self.calls.append(("log", step, dict(metrics)))

    def log_artifact(self, path, name=None):
        self.calls.append(("log_artifact", path, name))

    def finish(self):
        self.calls.append(("finish",))


def test_trackers_alike(tmp_path, monkeypatch):
    import sys
    import types
    import warnings

    from rtts.utils import tracking as JTr
    from rtts_torch.utils import tracking as TTr

    module = types.ModuleType("_rtts_torch_fake_tracker")
    module.factory = _FakeTracker
    monkeypatch.setitem(sys.modules, "_rtts_torch_fake_tracker", module)
    monkeypatch.setattr("time.time", lambda: 99.0)
    spec = "_rtts_torch_fake_tracker:factory"
    calls = {}
    for tracking, logger_cls, tag in ((JTr, JaxLogger, "jax"),
                                      (TTr, PortLogger, "port")):
        tracker = tracking.make_tracker(spec, "exp7",
                                        config={"model": {"d_model": 64}})
        logger = logger_cls(str(tmp_path / f"{tag}.jsonl"), echo=False,
                            tracker=tracker)
        logger.log(10, {"loss": np.float32(1.5), "note": "text"},
                   prefix="train/")
        logger.log_artifact(tmp_path / "mel.png", name="mel")
        logger.close()
        calls[tag] = tracker.calls
        assert tracking.make_tracker(None, "r") is None
        assert tracking.make_tracker("", "r") is None
        with pytest.raises(ValueError, match="unknown tracker"):
            tracking.make_tracker("mlflow", "r")
        for sdk in ("neptune", "wandb"):   # their SDKs are not installed
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                assert tracking.make_tracker(sdk, "r") is None
            assert any("unavailable" in str(w.message) for w in seen)
    assert calls["port"] == calls["jax"]
    assert calls["port"][1] == ("log", 10, {"train/loss": 1.5,
                                            "train/note": "text"})
    assert TTr._flatten({"a": {"b": 1, "c": {"d": 2}}, "e": 3}) == \
        JTr._flatten({"a": {"b": 1, "c": {"d": 2}}, "e": 3})


TRANSCRIPT_LINES = [
    "utt0001|hello world", "utt0002|1.25|3.5|timed text",
    "utt0003|media/talk.mp4|0.5|2|named source", "utt0004|a|b|c",
    "utt0005|12|x|not timed", "u|src.wav|1|2|text | with | bars",
    "u|2|3|text|with|bars",
]


def test_native_library_source_is_the_jax_packages():
    """``rtts_torch/csrc/rtts_native.cc`` is ``native/rtts_native.cc`` from
    its first ``#include`` on, byte for byte (only the header comment
    differs), and the port's bindings keep the JAX package's names and
    signatures."""
    import inspect

    from rtts.data import native_loader as JN
    from rtts_torch.data import native_loader as TN

    def code(path):
        text = path.read_text()
        return text[text.index("\n#include"):]

    assert code(ROOT / "rtts_torch" / "csrc" / "rtts_native.cc") == \
        code(ROOT / "native" / "rtts_native.cc")
    for name in ("available", "build_error", "write_clip", "read_clip",
                 "wav_read", "resample", "trim_silence"):
        assert inspect.signature(getattr(TN, name)) == \
            inspect.signature(getattr(JN, name)), name
    for name in ("__init__", "prefetch", "fill_batch", "fill_crops"):
        assert inspect.signature(getattr(TN.NativeClipLoader, name)) == \
            inspect.signature(getattr(JN.NativeClipLoader, name)), name


def test_preprocess_helpers_alike():
    from rtts.data import preprocess as JP
    from rtts_torch.data import preprocess as TP

    for line in TRANSCRIPT_LINES:
        assert TP.parse_transcript_line(line) == \
            JP.parse_transcript_line(line)
    for bad in ("no separator", ""):
        with pytest.raises(ValueError, match="malformed"):
            TP.parse_transcript_line(bad)
    rng = np.random.default_rng(4)
    sr = 16000
    quiet = np.zeros(sr // 4, np.float32)
    loud = (0.3 * rng.standard_normal(sr)).astype(np.float32)
    for audio in (np.concatenate([quiet, loud, quiet]), quiet, loud[:100],
                  loud, np.concatenate([quiet, 1e-4 * loud, loud])):
        for kw in ({}, {"threshold_db": -20.0, "frame_ms": 5.0}):
            np.testing.assert_array_equal(TP.trim_silence(audio, sr, **kw),
                                          JP.trim_silence(audio, sr, **kw))


_PATHS = ["encoder/layers/0/f/attn/w_qk/w", "decoder/layers/1/f/attn/w_q/w",
          "decoder/layers/1/f/attn/w_k/w", "decoder/layers/0/f/attn/w_v/w",
          "encoder/layers/1/f/attn/w_o/w", "encoder/layers/0/g/w_in/w",
          "encoder/layers/0/g/w_in/b", "decoder/layers/0/g/w_out/w",
          "decoder/layers/0/g/w_out/b", "embed/table", "postnet/0/conv/w",
          "mel_head/w", "block/ffn/w_in", "block/feed_forward/wo",
          "x/qkv", "x/out_proj", "0/mu/decoder/layers/1/f/attn/w_o/w",
          "flows/0/wn/in/v", "dec_prenet/fc1/w"]


def _spec(spec):
    """A PartitionSpec as the copies return it."""
    return tuple(spec) or None


@pytest.mark.parametrize("path", _PATHS)
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_param_sharding_rules_alike(path, ndim):
    from rtts.parallel.sharding import param_sharding_rules as jax_rules
    from rtts_torch.parallel.sharding import param_sharding_rules

    for tp in (False, True):
        assert param_sharding_rules(path, ndim, tp) == _spec(
            jax_rules(path, ndim, tp)), (path, ndim, tp)


@pytest.mark.parametrize("shape", [(32, 64), (3, 64), (5, 7), (8,), (2, 2, 6)])
@pytest.mark.parametrize("dp", [2, 4])
def test_zero_extend_alike(shape, dp):
    from jax.sharding import PartitionSpec as P

    from rtts.parallel.sharding import _zero_extend as jax_extend
    from rtts_torch.parallel.sharding import _zero_extend

    for spec in (P(), P(None, "model"), P("model", None)):
        if len(spec) > len(shape):
            continue
        assert _zero_extend(_spec(spec), shape, dp) == tuple(
            jax_extend(spec, shape, dp)), (spec, shape, dp)


@pytest.mark.parametrize("env", [{}, {"RTTS_MULTIHOST": "1"},
                                 {"RTTS_MULTIHOST": "0"}, {"WORLD_SIZE": "2"},
                                 {"TPU_WORKER_HOSTNAMES": "a,b"}])
def test_should_initialize_alike(env):
    from rtts.parallel.mesh import should_initialize as jax_should
    from rtts_torch.parallel.mesh import should_initialize

    for cfg in (None, JC.MeshConfig(), JC.MeshConfig(num_processes=2),
                JC.MeshConfig(coordinator_address="h:1234")):
        port = None if cfg is None else TC.from_dict(
            TC.MeshConfig, dataclasses.asdict(cfg))
        assert should_initialize(port, env) == jax_should(cfg, env)
