"""Train ``configs/parity_deep.yaml`` and ``parity_deep_guided.yaml`` to
their ``max_steps`` on the synthetic corpus through the port, then score
each final checkpoint's free-running decode in every mode and cache.

For each config: ``rtts_torch/scripts/run_training.sh`` (generate-corpus,
preprocess, train-tts; no vocoder) with the trainer's eval every 500 steps
(``parity_deep.yaml`` ships 1000; evals read the model and draw nothing
the steps draw), then ``python -m rtts_torch.scripts.eval_decode_fidelity
--batch 4 --kv-dtype float8_e4m3fn`` on the last checkpoint.  Writes the
trainers' metrics, the evaluations and a summary under ``results/`` in
the ``--work`` folder (a variant, such as ``-o
model.compute_dtype=float32``, takes a ``--work`` of its own) and prints
the summary as its last line:
the card's name and power limit, the val scalars at every eval, the step
wall (1 / the trainer's steps_per_sec over each 50-step window), and the
fidelity rows.  On a machine with one H100, from the repo root:

    python3 tools/parity_deep_study.py [--configs parity_deep,...]
        [--work build/parity_deep_study] [-o key.path=value ...]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
VAL_KEYS = ("val/mel_l1", "val/mcd", "val/stop_len_mae",
            "val/attn_diagonality", "val/attn_focus", "val/loss")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def _run(cmd, env=None) -> str:
    print("+", " ".join(cmd), flush=True)
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True)
    sys.stdout.write(p.stdout[-4000:])
    sys.stderr.write(p.stderr[-4000:])
    if p.returncode:
        raise SystemExit(f"{cmd[0]} ... exited {p.returncode}")
    return p.stdout


def study(name: str, work: pathlib.Path, out: pathlib.Path,
          overrides=()) -> dict:
    cfg = f"configs/{name}.yaml"
    run = work / name
    if run.exists():
        shutil.rmtree(run)
    opts = ["-o", f"dataset.data_dir={work / 'data'}",
            "-o", "experiment.logging.eval_every_steps=500"]
    opts += [a for o in overrides for a in ("-o", o)]
    env = dict(os.environ, RTTS_SKIP_VOCODER="1")
    t0 = time.time()
    _run(["bash", "rtts_torch/scripts/run_training.sh", cfg, str(run)]
         + opts, env)
    wall = time.time() - t0
    rows = [json.loads(line) for line in
            (run / "tts" / "metrics.jsonl").read_text().splitlines()]
    shutil.copy(run / "tts" / "metrics.jsonl",
                out / f"{name}_metrics.jsonl")
    evals = {r["step"]: {k: r[k] for k in VAL_KEYS if k in r}
             for r in rows if "val/mel_l1" in r}
    # the first window holds the kernels' build and the first step's set-up
    rates = [r["train/steps_per_sec"] for r in rows
             if "train/steps_per_sec" in r][1:]
    walls = sorted(1.0 / r for r in rates)
    t1 = time.time()
    text = _run([sys.executable, "-m",
                 "rtts_torch.scripts.eval_decode_fidelity", "-c", cfg]
                + opts + ["--ckpt", str(run / "tts" / "checkpoints"),
                              "--batch", "4", "--kv-dtype",
                              "float8_e4m3fn"])
    fid = json.loads(text.strip().splitlines()[-1])
    (out / f"{name}_fidelity.json").write_text(json.dumps(fid, indent=1))
    return {"script_s": wall, "eval_fidelity_s": time.time() - t1,
            "evals": evals,
            "step_wall_s": {"median": walls[len(walls) // 2] if walls
                            else None,
                            "min": walls[0] if walls else None,
                            "max": walls[-1] if walls else None,
                            "windows": len(walls)},
            "fidelity": fid}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="parity_deep,parity_deep_guided")
    ap.add_argument("--work", default="build/parity_deep_study")
    ap.add_argument("-o", "--override", action="append", default=[],
                    help="a config override for every run, as the CLI's")
    args = ap.parse_args()
    work = (ROOT / args.work).resolve()
    out = work / "results"
    out.mkdir(parents=True, exist_ok=True)
    summary = {"card": card(), "configs": {}}
    print(summary["card"], flush=True)
    for name in args.configs.split(","):
        summary["configs"][name] = study(name, work, out, args.override)
        (out / "summary.json").write_text(
            json.dumps(summary, indent=1))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
