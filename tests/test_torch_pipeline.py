"""The port's data pipeline and observability on the CPU.

- ``rtts_torch.data.preprocess.preprocess_corpus`` against the JAX
  package's (its Python branch: ``native_loader.available`` patched off)
  on a short corpus and on a long recording cut by transcript timing: the
  manifests equal, every clip's tokens and audio bit-equal, the log-mel
  within 1e-4 abs on every bin of at least 100x the log floor's energy and,
  on every bin, the mel energy within 1e-5 of the clip's peak (near the
  floor the log magnifies float32 rounding: there the JAX package's own
  log-mel is up to 3e-3 from a float64 one, the port's 3e-4);
  ``write_clip`` writes the JAX package's bytes.
- ``MetricLogger``'s TensorBoard sink: the event files hold the logged
  tags, steps and values.
- ``rtts_torch.utils.profiling``: ``trace`` writes a Chrome trace that
  names an ``annotate`` range; ``timed`` returns (best, result).
- ``experiment.debug_nans``: a NaN in one batch raises FloatingPointError
  under the flag (the step's check, and anomaly mode's), not without it.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import rtts.config as JC
import rtts_torch.config as TC
from rtts.data import corpus as JCo
from rtts.data import native_loader as JN
from rtts.data import preprocess as JP
from rtts_torch.data import dataset as TD
from rtts_torch.data import preprocess as TP
from torch_twin import one_thread  # noqa: F401  (autouse)

MEL_TOL = 1e-4
ENERGY_TOL = 1e-5


def assert_mel_close(got, want, log_floor=1e-5):
    """Log-mel within MEL_TOL where the energy is >= 100 log floors, and the
    energies within ENERGY_TOL of the peak everywhere."""
    loud = want >= np.log(100 * log_floor)
    assert loud.mean() > 0.3
    np.testing.assert_allclose(got[loud], want[loud], rtol=0, atol=MEL_TOL)
    np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=0,
                               atol=ENERGY_TOL * np.exp(want).max())


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline_corpus")
    JCo.generate_corpus(root, 4, 22050)
    JCo.generate_long_recording(root, 2, 22050)
    return root


def _clips(manifest_path):
    with open(manifest_path) as f:
        man = json.load(f)
    root = str(pathlib.Path(manifest_path).parent)
    clips = [dict(c, clip=c["clip"][len(root):]) for c in man["clips"]]
    return dict(man, clips=clips), [TD.read_clip(c["clip"])
                                    for c in man["clips"]]


@pytest.mark.parametrize("transcripts", ["transcripts.txt",
                                         "transcripts_timed.txt"])
def test_preprocess_equals_jax(corpus_dir, transcripts, tmp_path,
                               monkeypatch):
    monkeypatch.setattr(JN, "available", lambda: False)
    tpath = str(corpus_dir / transcripts)
    out = {}
    for tag in ("jax", "port"):
        data = {"data_dir": str(tmp_path / tag)}
        if tag == "jax":
            out[tag] = JP.preprocess_corpus(
                JC.from_dict(JC.DatasetConfig, data), tpath)
        else:
            out[tag] = TP.preprocess_corpus(
                TC.from_dict(TC.DatasetConfig, data), tpath, device="cpu")
    (jman, jclips), (tman, tclips) = _clips(out["jax"]), _clips(out["port"])
    assert tman == jman
    assert len(tclips) == (4 if transcripts == "transcripts.txt" else 2)
    for (tt, tm, ta), (jt, jm, ja) in zip(tclips, jclips):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(ta, ja)
        assert tm.shape == jm.shape and tm.dtype == jm.dtype
        assert_mel_close(tm, jm)


def test_write_clip_writes_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 60, 17).astype(np.int64)
    mel = rng.standard_normal((9, 5))
    audio = rng.standard_normal(300).astype(np.float32)
    TD.write_clip(str(tmp_path / "port.rclip"), tokens, mel, audio)
    JN.write_clip(str(tmp_path / "jax.rclip"), tokens, mel, audio)
    assert (tmp_path / "port.rclip").read_bytes() == \
        (tmp_path / "jax.rclip").read_bytes()
    got = TD.read_clip(str(tmp_path / "port.rclip"))
    for g, w in zip(got, (tokens, mel, audio)):
        np.testing.assert_array_equal(g, w.astype(g.dtype))


def test_tensorboard_sink_writes_the_logged_scalars(tmp_path, monkeypatch):
    import sys

    # torch.utils.tensorboard imports TensorFlow where it is installed (10 s
    # or more); without it, tensorboard writes the same events
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    from tensorboard.backend.event_processing import event_accumulator

    from rtts_torch.utils.metrics import MetricLogger

    logger = MetricLogger(str(tmp_path / "m.jsonl"), str(tmp_path / "tb"),
                          echo=False)
    logged = {1: {"loss": 2.5, "lr": 1e-3}, 2: {"loss": 1.25, "lr": 2e-3},
              5: {"loss": 0.5, "note": "text"}}
    for step, metrics in logged.items():
        logger.log(step, metrics, prefix="train/")
    logger.log(5, {"mcd": 7.75}, prefix="val/")
    logger.close()
    acc = event_accumulator.EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == ["train/loss", "train/lr",
                                             "val/mcd"]
    got = {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
           for tag in acc.Tags()["scalars"]}
    want = {"train/loss": [(1, 2.5), (2, 1.25), (5, 0.5)],
            "train/lr": [(1, 1e-3), (2, 2e-3)], "val/mcd": [(5, 7.75)]}
    assert got.keys() == want.keys()
    for tag in want:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]]
        np.testing.assert_allclose([v for _, v in got[tag]],
                                   [v for _, v in want[tag]], rtol=1e-7)


def test_tensorboard_missing_warns_and_logging_goes_on(tmp_path, monkeypatch):
    import sys

    from rtts_torch.utils.metrics import MetricLogger

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.warns(UserWarning, match="tensorboard package"):
        logger = MetricLogger(str(tmp_path / "m.jsonl"), str(tmp_path / "tb"),
                              echo=False)
    logger.log(1, {"loss": 2.0})
    logger.close()
    assert json.loads((tmp_path / "m.jsonl").read_text())["loss"] == 2.0


def test_trace_names_annotated_ranges_and_timed_returns_best(tmp_path):
    from rtts_torch.utils import profiling

    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("rtts_range_under_test"):
            y = x @ x
    text = pathlib.Path(prof.trace_file).read_text()
    assert pathlib.Path(prof.trace_file).parent == tmp_path / "trace"
    assert "rtts_range_under_test" in text
    names = [e.get("name") for e in json.loads(text)["traceEvents"]]
    assert "rtts_range_under_test" in names
    calls = []

    def fn(a):
        calls.append(a)
        return a @ a

    best, result = profiling.timed(fn, x, repeats=3, warmup=2)
    assert len(calls) == 5 and 0.0 < best < 10.0
    torch.testing.assert_close(result, y)


def _tiny_tts():
    from rtts_torch.text import frontend_vocab_size

    att = {"kind": "full", "num_heads": 2, "head_dim": 16}
    stack = {"num_layers": 1, "d_model": 32, "d_ff": 64, "attention": att}
    return TC.from_dict(TC.Config, {
        "model": {"vocab_size": frontend_vocab_size(), "d_model": 32,
                  "n_mels": 20, "encoder": dict(stack, causal=False),
                  "decoder": dict(stack, causal=True),
                  "dec_prenet_hidden": 16, "postnet_channels": 16,
                  "max_pos": 64, "compute_dtype": "float32"},
        "experiment": {"optim": {"warmup_steps": 1}}})


@pytest.mark.parametrize("anomaly", [False, True])
def test_debug_nans_raises_on_a_nan_batch(anomaly):
    from rtts_torch.models import reformer_tts as M
    from rtts_torch.train.optim import make_optimizer
    from rtts_torch.train.train_tts import make_train_step, step_generator
    from rtts_torch.utils.profiling import enable_nan_debugging

    cfg = _tiny_tts()
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(3, 40, (2, 9), generator=g),
             "token_mask": torch.arange(9)[None] < torch.tensor([[9], [6]]),
             "mel": torch.randn(2, 12, 20, generator=g),
             "mel_mask": torch.arange(12)[None] < torch.tensor([[12], [7]])}
    bad = dict(batch, mel=batch["mel"].clone())
    bad["mel"][1, 3, 5] = float("nan")
    opt = make_optimizer(cfg.experiment.optim)

    def run(debug, b):
        """-> (metrics, or the FloatingPointError raised; whether the
        parameters are unchanged)."""
        model = M.init(cfg.model, torch.Generator().manual_seed(0), "cpu")
        state = opt.init(list(model.parameters()))
        step = make_train_step(cfg.model, opt, debug_nans=debug)
        before = [p.detach().clone() for p in model.parameters()]
        try:
            with enable_nan_debugging(anomaly and debug):
                out = step(model, state, b, step_generator(0, 0, "cpu"))
        except FloatingPointError as e:
            out = e
        return out, all(torch.equal(a, p) for a, p in
                        zip(before, model.parameters()))

    clean, _ = run(True, batch)
    assert np.isfinite(float(clean["loss"]))
    assert float(run(False, batch)[0]["loss"]) == float(clean["loss"])
    err, unchanged = run(True, bad)
    assert isinstance(err, FloatingPointError) and unchanged
    assert str(err).startswith("debug_nans: ")
    if not anomaly:   # the step's own check names the loss
        assert str(err) == "debug_nans: loss is not finite"
    metrics, unchanged = run(False, bad)   # without the flag: no raise
    assert not np.isfinite(float(metrics["loss"])) and not unchanged
    assert not torch.is_anomaly_enabled()
