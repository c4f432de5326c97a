"""The port's decode-fidelity evaluation (``python -m rtts_torch.scripts.
eval_decode_fidelity``) against the JAX package's
(``scripts/eval_decode_fidelity.py``) on the CPU.

A six-clip corpus (``preprocess_corpus``), a checkpoint of
``configs/tiny.yaml``'s model saved by the JAX package, and the same
arguments (ground truth cut to 32 frames, the decoder prenet's always-on
dropout at 0: JAX's Threefry bits cannot be matched).  The JAX script runs
in a subprocess (``--platform cpu``, its compilation cache under the
test's directory); the port's module runs in this process with ``--device
cpu``.  ``kv_lsh`` draws its hash rotations from JAX's Threefry, which the
port cannot reproduce: JAX's rotations for the decode
(``rtts.infer.decode._decode_rotations`` with the key that
``decode_greedy`` derives from the script's) are
injected through ``rtts_torch.infer.draws.draw_rotations``, as in
``tests/test_torch_decode_modes.py``.

Held: the final JSON line's ``step``, ``max_frames``, modes and keys, and
every ``lengths`` equal, so the stop-length scores and stop deltas equal
exactly; mel L1 and MCD within ``REL`` relative (the mel itself is within
1e-4 of JAX's, ``tests/test_torch_decode_modes.py``), L1 against the
recompute trajectory within ``ABS`` (it is near 0 for kv_full), the f8
cache's relative cost within ``PCT`` percentage points.  With
``--vocoder-ckpt`` (a JAX vocoder checkpoint) or ``--waveform`` the port's
MR-STFT scores are finite (the vocoder's noise and Griffin-Lim's initial
phase are each framework's own draws, so the scores are not compared).
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import rtts.config as JC
from rtts.data import corpus as JCo
from rtts.data import preprocess as JP
from rtts.infer import decode as JD
from rtts.models import reformer_tts as JM
from rtts.models import squeezewave as JSW
from rtts.text import frontend_vocab_size
from rtts.train.checkpoint import save_checkpoint
from rtts_torch.infer import draws
from rtts_torch.scripts import eval_decode_fidelity as EF
from torch_twin import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = str(ROOT / "configs" / "tiny.yaml")
FRAMES = 32
REL, ABS, PCT = 1e-4, 1e-4, 2e-2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_fidelity")
    JCo.generate_corpus(root, 6, 22050)
    over = [f"dataset.data_dir={root / 'data'}",
            f"dataset.max_mel_len={FRAMES}", "model.dec_prenet_dropout=0.0"]
    cfg = JC.load_config(TINY, over)
    JP.preprocess_corpus(cfg.dataset, str(root / "transcripts.txt"))
    model = dataclasses.replace(cfg.model, vocab_size=frontend_vocab_size())
    save_checkpoint(root / "tts", {"params": JM.init(jax.random.PRNGKey(3),
                                                     model)}, 4)
    save_checkpoint(root / "voc", {"params": JSW.init(jax.random.PRNGKey(4),
                                                      cfg.vocoder)}, 2)
    args = ["-c", TINY] + [a for o in over for a in ("-o", o)] + [
        "--ckpt", str(root / "tts")]
    return root, model, args


def _jax_eval(args, root):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               RTTS_COMPILE_CACHE=str(root / "jax_cache"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "eval_decode_fidelity.py"),
         *args, "--platform", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port_eval(args, model, monkeypatch, capsys):
    # the script's key, PRNGKey(0), in decode_greedy's rotation namespace
    key = jax.random.fold_in(jax.random.PRNGKey(0), JD._ROT_KEY)
    rots, _ = JD._decode_rotations(model, key, FRAMES)
    drawn = []

    def draw(h, d, n_hashes, half, generator, device):
        drawn.append((h, d, n_hashes, half))
        return torch.from_numpy(np.array(rots[(len(drawn) - 1) % len(rots)]))

    monkeypatch.setattr(draws, "draw_rotations", draw)
    capsys.readouterr()
    out = EF.main(args + ["--device", "cpu"])
    said = capsys.readouterr().out.strip().splitlines()
    assert json.loads(said[-1]) == out
    return out, drawn


def _assert_match(got, want):
    assert (got["step"], got["max_frames"]) == (want["step"],
                                                want["max_frames"])
    assert list(got["results"]) == list(want["results"])
    for mode, w in want["results"].items():
        g = got["results"][mode]
        assert sorted(g) == sorted(w), mode
        assert g["lengths"] == w["lengths"], mode
        for key in ("stop_len_mae_vs_gt", "stop_delta_max",
                    "stop_delta_vs_bf16"):
            assert g.get(key) == w.get(key), (mode, key)
        for key in ("mel_l1_vs_gt", "mcd_vs_gt"):
            if key in w:
                assert abs(g[key] - w[key]) <= REL * abs(w[key]), (mode, key)
        if "mel_l1_vs_recompute" in w:
            assert abs(g["mel_l1_vs_recompute"]
                       - w["mel_l1_vs_recompute"]) <= ABS, mode
        if "rel_cost_vs_gt_pct" in w:
            assert abs(g["rel_cost_vs_gt_pct"]
                       - w["rel_cost_vs_gt_pct"]) <= PCT, mode


@pytest.mark.parametrize("extra", [
    ["--modes", "recompute,kv_full,kv_lsh", "--kv-dtype", "float8_e4m3fn"],
    ["--modes", "kv_full,kv_lsh_chunk", "--window", "2,4",
     "--stop-threshold", "0.9"],
], ids=["modes_f8", "window"])
def test_matches_the_jax_script(setup, extra, monkeypatch, capsys):
    root, model, args = setup
    want = _jax_eval(args + extra, root)
    got, drawn = _port_eval(args + extra, model, monkeypatch, capsys)
    _assert_match(got, want)
    lsh_runs = sum(m.split("@")[0] in ("kv_lsh", "kv_lsh_chunk")
                   for m in want["results"])
    assert len(drawn) == lsh_runs * model.decoder.num_layers
    assert want["max_frames"] == FRAMES


@pytest.mark.parametrize("render", [["--vocoder-ckpt", "voc"],
                                    ["--waveform"]], ids=["vocoder", "gl"])
def test_waveform_scores_are_finite(setup, render, monkeypatch, capsys):
    root, model, args = setup
    if render[0] == "--vocoder-ckpt":
        render = [render[0], str(root / render[1])]
    out, _ = _port_eval(args + ["--modes", "recompute,kv_full"] + render,
                        model, monkeypatch, capsys)
    for mode, row in out["results"].items():
        for key in ("mr_stft_vs_gt", "spectral_convergence_vs_gt"):
            assert np.isfinite(row[key]) and row[key] >= 0, (mode, key)
    assert out["results"]["kv_full"]["mel_l1_vs_recompute"] <= ABS


def test_missing_checkpoint_exits(setup, tmp_path):
    _, _, args = setup
    with pytest.raises(SystemExit, match="no checkpoint under"):
        EF.main(args[:-1] + [str(tmp_path), "--device", "cpu"])
