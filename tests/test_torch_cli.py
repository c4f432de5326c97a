"""The port's command line (``rtts_torch/cli.py``) against the JAX
package's (``rtts/cli.py``) on the CPU.

(a) The verbs, and each verb's options (strings, destinations, defaults,
    choices, types, required), equal the click group's; ``--platform`` ->
    ``--device`` is the one difference.
(b) The README's quick start at ``configs/tiny.yaml`` through ``main``:
    generate-corpus, preprocess, train-tts and train-vocoder (checkpoints,
    ``metrics.jsonl``), predict with both checkpoints and serve: finite
    wavs.
(c) A TTS and a vocoder checkpoint written by the JAX package load through
    the port's ``_load_synthesizer`` to the parameters the JAX package's
    restores, bit for bit (the folded vocoder within f32 rounding).
(d) Overrides, a misspelled key, a malformed override, a missing path and
    an empty ``serve`` fail as the JAX package's do; ``export`` and
    ``predict --from-export`` round-trip to live ``predict``'s wavs;
    ``bench --which vocoder_train`` on the CPU prints its JSON line;
    ``download`` without network names ``generate_corpus``.
"""

import argparse
import contextlib
import io
import pathlib
import wave

import jax
import numpy as np
import pytest
from click.testing import CliRunner

from rtts import cli as JCLI
from rtts_torch import cli as TCLI
from torch_twin import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = str(ROOT / "configs" / "tiny.yaml")


def _click_options(params) -> dict:
    out = {}
    for p in params:
        opts = tuple(sorted(p.opts + p.secondary_opts))
        default = p.default
        if type(default).__name__ == "Sentinel":   # click's "no default"
            default = None
        if p.multiple:
            default = list(default or ())
        kind = {"integer": int, "float": float}.get(p.type.name)
        out[opts] = (p.name, default, tuple(getattr(p.type, "choices", ())
                                            or ()), kind, p.required)
    return out


def _argparse_options(parser) -> dict:
    out = {}
    for a in parser._actions:
        if isinstance(a, (argparse._HelpAction, argparse._SubParsersAction)):
            continue
        out[tuple(sorted(a.option_strings))] = (
            a.dest, a.default, tuple(a.choices or ()), a.type, a.required)
    return out


def _verbs(parser) -> dict:
    (sub,) = [a for a in parser._actions
              if isinstance(a, argparse._SubParsersAction)]
    return sub.choices


def test_verbs_and_options_equal_the_jax_cli():
    parser = TCLI.build_parser()
    verbs = _verbs(parser)
    assert list(verbs) == list(JCLI.cli.commands)
    for name, cmd in JCLI.cli.commands.items():
        assert _argparse_options(verbs[name]) == _click_options(cmd.params), \
            name
    got, want = _argparse_options(parser), _click_options(JCLI.cli.params)
    assert got.pop(("--device",)) == ("device", "cuda", ("cuda", "cpu"),
                                      None, False)
    assert want.pop(("--platform",))[0] == "platform"
    assert got == want


def _wav_samples(path) -> np.ndarray:
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def test_quick_start_on_tiny_yaml(tmp_path, capsys):
    data = tmp_path / "data"
    top = ["-c", TINY, "-o", f"dataset.data_dir={data}", "--device", "cpu"]
    runs = tmp_path / "runs"
    assert TCLI.main(top + ["generate-corpus", "-n", "8"]) == 0
    assert len(list((data / "wavs").glob("*.wav"))) == 8
    assert TCLI.main(top + ["preprocess"]) == 0
    assert len(list((data / "clips").glob("*.rclip"))) == 8
    for verb in ("tts", "vocoder"):
        assert TCLI.main(top + [f"train-{verb}", "--workdir",
                                str(runs / verb), "--max-steps", "2"]) == 0
        assert (runs / verb / "checkpoints" / "step_2" / "leaves.npz").exists()
        assert (runs / verb / "metrics.jsonl").read_text().count("\n") >= 2
    ckpts = ["--tts-ckpt", str(runs / "tts" / "checkpoints"),
             "--vocoder-ckpt", str(runs / "vocoder" / "checkpoints")]
    out = tmp_path / "synth"
    assert TCLI.main(top + ["predict", "--text", "hello world", "--text",
                            "a second one"] + ckpts + [
        "--max-frames", "16", "--out", str(out)]) == 0
    texts = tmp_path / "texts.txt"
    texts.write_text("served from a file\n\n")
    assert TCLI.main(top + ["serve", "--text", "an inline request",
                            "--texts-file", str(texts)] + ckpts + [
        "--max-frames", "16", "--out", str(tmp_path / "serve")]) == 0
    said = capsys.readouterr().out
    assert "loaded TTS step 2" in said and "loaded vocoder step 2" in said
    for folder in (out, tmp_path / "serve"):
        wavs = sorted(folder.glob("sample_*.wav"))
        assert [w.name for w in wavs] == ["sample_0.wav", "sample_1.wav"]
        for w in wavs:
            samples = _wav_samples(w)
            assert len(samples) > 0 and np.isfinite(samples).all()


def _flat(module) -> dict:
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def test_jax_checkpoints_load_bit_for_bit(tmp_path, monkeypatch):
    import dataclasses

    import rtts.config as JC
    from rtts.models import reformer_tts as JM
    from rtts.models import squeezewave as JSW
    from rtts.text import frontend_vocab_size
    from rtts.train.checkpoint import save_checkpoint
    from rtts_torch import config as TC
    from rtts_torch.convert import _flatten
    from rtts_torch.models import squeezewave as TSW

    jcfg = JC.load_config(TINY)
    model_cfg = dataclasses.replace(jcfg.model,
                                    vocab_size=frontend_vocab_size())
    tts = JM.init(jax.random.PRNGKey(7), model_cfg)
    voc = JSW.init(jax.random.PRNGKey(8), jcfg.vocoder)
    save_checkpoint(tmp_path / "tts", {"params": tts}, 3)
    save_checkpoint(tmp_path / "voc", {"params": voc}, 5)

    unfolded = {}

    def capture(module, tag):
        fold = module.fold_weightnorm

        def wrapped(tree):
            unfolded[tag] = tree
            return fold(tree)

        monkeypatch.setattr(module, "fold_weightnorm", wrapped)

    capture(JSW, "jax")
    capture(TSW, "port")
    # a step directory (TTS) and a directory of steps (vocoder)
    args = (str(tmp_path / "tts" / "step_3"), str(tmp_path / "voc"), 16,
            "auto")
    want = JCLI._load_synthesizer(jcfg, *args)
    got = TCLI._load_synthesizer(TC.load_config(TINY), *args, "cpu")
    np_tree = lambda t: _flatten(jax.tree.map(np.asarray, t))  # noqa: E731
    for port, jax_tree in ((_flat(got.tts), want.tts_params),
                           (_flat(unfolded["port"]), unfolded["jax"])):
        ref = np_tree(jax_tree)
        assert sorted(port) == sorted(ref)
        for key in ref:
            np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
    # the vocoder's stored leaves are the JAX initializer's, bit for bit
    for key, value in np_tree(voc).items():
        np.testing.assert_array_equal(_flat(unfolded["port"])[key], value)
    folded, ref = _flat(got.vocoder), np_tree(want.vocoder_params)
    assert sorted(folded) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(folded[key], ref[key], rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(ref[key]).max()),
                                   err_msg=key)


def _both(args):
    """(the port's exception or status, the JAX package's)."""
    try:
        port = TCLI.main(args)
    except Exception as e:  # noqa: BLE001 — compared below
        port = e
    r = CliRunner().invoke(JCLI.cli, args)
    return port, (r.exception if r.exception and r.exit_code == 1
                  else r.exit_code)


def test_overrides_and_errors_as_the_jax_cli(tmp_path, monkeypatch):
    cfgfile = tmp_path / "c.yaml"
    cfgfile.write_text("model:\n  d_model: 48\n")
    gen = ["generate-corpus", "--out", str(tmp_path / "corpus"), "-n", "1"]
    for bad, kind in ((["-o", "model.bogus=1"], KeyError),
                      (["-o", "model.d_model"], ValueError),
                      (["-o", "model.d_model.x=1"], ValueError),
                      (["-o", "model.d_model=true"], TypeError)):
        port, ref = _both(["-c", str(cfgfile)] + bad + gen)
        assert type(port) is type(ref) is kind, (bad, port, ref)
        assert str(port) == str(ref)
    assert "bogus" in str(_both(["-o", "model.bogus=1"] + gen)[0])
    loaded = {}
    monkeypatch.setattr(TCLI, "_generate_corpus",
                        lambda cfg, args: loaded.update(cfg=cfg))
    assert TCLI.main(["-c", str(cfgfile), "-o", "model.n_mels=40",
                      "--device", "cpu"] + gen) == 0
    assert (loaded["cfg"].model.d_model, loaded["cfg"].model.n_mels) == \
        (48, 40)
    missing = str(tmp_path / "missing.yaml")
    assert _both(["-c", missing] + gen) == (2, 2)
    assert _both(["serve", "--texts-file", missing]) == (2, 2)
    assert _both(["predict", "--text", "x", "--from-export", missing]) == \
        (2, 2)
    assert _both(["bogus-verb"]) == (2, 2)
    assert _both(["generate-corpus", "-n", "many"]) == (2, 2)
    assert TCLI.main(["--device", "cpu", "serve"]) == 2   # no requests
    assert TCLI.main(["--help"]) == 0


def test_unported_verbs_raise_and_download_names_the_corpus(tmp_path,
                                                            monkeypatch):
    """``export`` then ``predict --from-export`` (tiny.yaml, random
    weights seeded 0, no vocoder: Griffin-Lim) write the wavs that live
    ``predict`` writes; ``bench --which vocoder_train`` at tiny.yaml on the
    CPU prints one JSON line (``rtts_torch.bench.run_bench``'s);
    ``download`` without network names ``generate_corpus``."""
    import json
    import urllib.error

    top = ["-c", TINY, "--device", "cpu"]
    exp = tmp_path / "export"
    assert TCLI.main(top + ["export", "--out", str(exp), "--max-frames",
                            "16", "--batch-sizes", "2", "--mode",
                            "kv_full"]) == 0
    manifest = json.loads((exp / "manifest.json").read_text())
    assert (manifest["batch_sizes"], manifest["device"]) == ([2], "cpu")
    texts = ["--text", "hello world", "--text", "a second one"]
    for name, how in (("live", ["--max-frames", "16", "--mode", "kv_full"]),
                      ("exported", ["--from-export", str(exp)])):
        assert TCLI.main(top + ["predict"] + texts + how + [
            "--out", str(tmp_path / name)]) == 0
    for i in range(2):
        live = _wav_samples(tmp_path / "live" / f"sample_{i}.wav")
        got = _wav_samples(tmp_path / "exported" / f"sample_{i}.wav")
        assert len(got) == len(live) > 0
        np.testing.assert_allclose(got, live, atol=1)   # int16 steps
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        assert TCLI.main(top + ["bench", "--which", "vocoder_train"]) == 0
    (line,) = said.getvalue().splitlines()
    got = json.loads(line)
    assert got["metric"] == "vocoder_train_rtf" and got["value"] > 0
    assert got["detail"]["device"] == "cpu"

    def offline(url, timeout=None):
        raise urllib.error.URLError("no network")

    monkeypatch.setattr("urllib.request.urlopen", offline)
    with pytest.raises(RuntimeError, match="generate_corpus"):
        TCLI.main(["download", "--index-url", "http://example.invalid/x",
                   "--out", str(tmp_path)])
