"""The JAX package's trainer and the port's on one synthetic corpus, on the
CPU, at a small width: do their validation curves agree?

Both ``train-tts`` runs start from the same config (a YAML of ``configs/``,
``parity_deep_guided.yaml`` by default, cut to d 64, 2 + 2 layers of
2 x 32 heads, float32, frames to 256), each package's own command line
(``python -m rtts.cli ... --platform cpu`` and
``python -m rtts_torch.cli ... --device cpu``), side by side in two
processes; the corpus is made once by the port (the two packages' corpus
and clips are bit-equal, ``tests/test_torch_copies.py``,
``tests/test_torch_pipeline.py``).  Dropout draws differ between the
packages, so the curves agree in trend and size, not bit for bit.  Then
each package's decode-fidelity script (``scripts/eval_decode_fidelity.py``,
``python -m rtts_torch.scripts.eval_decode_fidelity``, ``--batch 4``)
scores each package's final checkpoint: the free-running error of a
JAX-trained and a port-trained model, each decoded by both.  Prints the
val scalars of each eval side by side, each mode's free-running mel L1,
then one JSON line.  Every run starts from nothing: the corpus, both
trainings and their checkpoints are made anew under ``--work`` (by default
``build/train_quality_ab`` in the checkout), which must not exist yet, so
no run scores another run's checkpoints.

    python3 tools/train_quality_ab.py [--config CONFIG.yaml] [--steps 2000]
        [--eval-every 250] [--work build/train_quality_ab]

A reference comparison for the CPU (the JAX package is not run on the
card); ~20 min at the defaults on 6 cores.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = ["model.d_model=64", "model.encoder.d_model=64",
         "model.decoder.d_model=64", "model.encoder.d_ff=128",
         "model.decoder.d_ff=128", "model.encoder.num_layers=2",
         "model.decoder.num_layers=2", "model.encoder.attention.num_heads=2",
         "model.encoder.attention.head_dim=32",
         "model.decoder.attention.num_heads=2",
         "model.decoder.attention.head_dim=32", "model.compute_dtype=float32",
         "dataset.max_mel_len=256", "experiment.logging.log_every_steps=50"]
KEYS = ("val/mel_l1", "val/mcd", "val/stop_len_mae", "val/attn_diagonality")


def _evals(path: pathlib.Path) -> dict:
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return {r["step"]: {k: r[k] for k in KEYS if k in r}
            for r in rows if "val/mel_l1" in r}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/parity_deep_guided.yaml")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--work", default="build/train_quality_ab")
    args = ap.parse_args()
    work = (ROOT / args.work).resolve()
    if work.exists():
        raise SystemExit(f"{work} exists: remove it or name another --work")
    work.mkdir(parents=True)
    over = SMALL + [f"dataset.data_dir={work / 'data'}",
                    f"experiment.max_steps={args.steps}",
                    f"experiment.logging.eval_every_steps={args.eval_every}"]
    top = ["-c", args.config] + [a for o in over for a in ("-o", o)]
    port = [sys.executable, "-m", "rtts_torch.cli"] + top + ["--device",
                                                             "cpu"]
    for verb in ("generate-corpus", "preprocess"):
        subprocess.run(port + [verb], cwd=ROOT, check=True)
    env = dict(os.environ, OMP_NUM_THREADS="3", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT))
    runs = {"jax": [sys.executable, "-m", "rtts.cli"] + top
            + ["--platform", "cpu"],
            "port": port}
    procs = {}
    for name, cmd in runs.items():
        log = open(work / f"{name}.log", "w")
        procs[name] = subprocess.Popen(
            cmd + ["train-tts", "--workdir", str(work / name)], cwd=ROOT,
            env=env, stdout=log, stderr=subprocess.STDOUT)
    codes = {name: p.wait() for name, p in procs.items()}
    if any(codes.values()):
        raise SystemExit(f"train-tts exited {codes}; logs under {work}")
    evals = {name: _evals(work / name / "metrics.jsonl") for name in runs}
    scripts = {"jax": [sys.executable, str(ROOT / "scripts" /
                                            "eval_decode_fidelity.py")]
               + top + ["--platform", "cpu"],
               "port": [sys.executable, "-m",
                        "rtts_torch.scripts.eval_decode_fidelity"]
               + top + ["--device", "cpu"]}
    procs = {(s, ck): subprocess.Popen(
        cmd + ["--ckpt", str(work / ck / "checkpoints"), "--batch", "4"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True) for s, cmd in scripts.items() for ck in runs}
    fidelity = {}
    for (script, ck), proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"the {script} evaluation of {ck}'s checkpoint "
                             f"exited {proc.returncode}")
        fidelity[f"{ck} checkpoint, {script} decode"] = json.loads(
            out.strip().splitlines()[-1])["results"]
    for step in sorted(evals["jax"]):
        print(f"step {step}: " + "; ".join(
            f"{name} " + ", ".join(f"{k[4:]} {v.get(k, float('nan')):.4f}"
                                   for k in KEYS)
            for name, v in ((n, evals[n].get(step, {})) for n in runs)))
    for what, rows in fidelity.items():
        print(f"{what}: " + "; ".join(
            f"{mode} L1 {r['mel_l1_vs_gt']:.4f} stopMAE "
            f"{r['stop_len_mae_vs_gt']:.2f}" for mode, r in rows.items()))
    print(json.dumps({"config": args.config, "small": SMALL,
                      "steps": args.steps, "evals": evals,
                      "fidelity": fidelity}))


if __name__ == "__main__":
    main()
