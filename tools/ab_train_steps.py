#!/usr/bin/env python3
"""Time the base.yaml, longform_8k.yaml and serving_fast.yaml train steps
of two checkouts of this repo on one NVIDIA GPU, in the order A B B A.

    python3 tools/ab_train_steps.py DIR_A DIR_B [CYCLES]

CYCLES (default 1) repeats the order A B B A.
Each run is a process of its own that imports the ``chip_smoke.py`` of its
checkout, so the port and the kernels are that checkout's: it builds the
kernels, makes seeded weights and runs the checkout's base.yaml,
longform_8k.yaml and serving_fast.yaml timing phases (best of 3 after a
warm-up, one profiled step, the kernels against their plain versions; the
serving_fast phase times four variants, of which the step as shipped,
reversible with the chunked FFN, is read here).  Prints every run's lines
prefixed by its label, then one JSON line of each run's best step wall, of
every timed step's wall and of the profiled step's device busy time.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys

_RUN = """
import sys
import torch
sys.path.insert(0, {root!r})
import chip_smoke as S
from rtts_torch.models import reformer_tts as M
S.phase_device()
S.phase_build()
for base, timing in ((S.BASE_CONFIG, S.phase_train_timing),
                     (S.LONGFORM_CONFIG, S.phase_train_lsh_timing),
                     (S.SERVING_FAST_CONFIG,
                      S.phase_train_serving_fast_timing)):
    cfg = S.train_config(base=base)
    model = M.init(cfg.model, torch.Generator().manual_seed(S.SEED_TTS),
                   "cuda")
    timing(model)
    del model
    torch.cuda.empty_cache()
"""
_SHIPPED = "reversible \\+ chunked FFN \\(as shipped\\)"
_STEP = re.compile(r"^\[(train-timing|train-lsh-timing|train-rev-timing)\] "
                   r"(?:" + _SHIPPED + r": )?train step .*"
                   r"walls \[([0-9., ]+)\] s; best ([0-9.]+) s")
_BUSY = re.compile(r"^\[(train-timing|train-lsh-timing|train-rev-timing)\] "
                   r"profile of one (?:" + _SHIPPED + r" )?step: wall [0-9.]+ "
                   r"s, device busy ([0-9.]+) s")


def main(argv) -> int:
    if len(argv) not in (3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    cycles = int(argv[3]) if len(argv) == 4 else 1
    roots = {"A": pathlib.Path(argv[1]).resolve(),
             "B": pathlib.Path(argv[2]).resolve()}
    best = {"A": {}, "B": {}}
    walls = {"A": {}, "B": {}}
    busy = {"A": {}, "B": {}}
    for label in "ABBA" * cycles:
        root = roots[label]
        proc = subprocess.run([sys.executable, "-c", _RUN.format(root=str(root))],
                              cwd=root, capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            print(f"{label} {line}")
            hit = _STEP.match(line)
            if hit:
                best[label].setdefault(hit.group(1), []).append(
                    float(hit.group(3)))
                walls[label].setdefault(hit.group(1), []).extend(
                    float(w) for w in hit.group(2).split(","))
            hit = _BUSY.match(line)
            if hit:
                busy[label].setdefault(hit.group(1), []).append(
                    float(hit.group(2)))
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            print(f"{label} ({root}) exited {proc.returncode}", file=sys.stderr)
            return 1
    print(json.dumps({"best_step_s": best, "step_walls_s": walls,
                      "device_busy_s": busy,
                      "roots": {k: str(v) for k, v in roots.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
