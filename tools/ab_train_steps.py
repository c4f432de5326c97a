#!/usr/bin/env python3
"""Time the train steps, or K4, K6 and the LSH bucket sort, of two checkouts
of this repo on one NVIDIA GPU, in the order A B B A.

    python3 tools/ab_train_steps.py DIR_A DIR_B [CYCLES]
    python3 tools/ab_train_steps.py --kernels DIR_A DIR_B [CYCLES]

CYCLES (default 1) repeats the order A B B A.
Each run is a process of its own that imports the ``chip_smoke.py`` of its
checkout, so the port and the kernels are that checkout's.

Steps (the default): it builds the kernels, makes seeded weights and runs
the checkout's base.yaml, longform_8k.yaml and serving_fast.yaml timing
phases (best of 3 after a warm-up, one profiled step, the kernels against
their plain versions; the serving_fast phase times four variants, of which
two are read here: the step as shipped, reversible with the chunked FFN,
and reversible + K6, under "train-rev-timing K6").  The JSON line holds
each run's best step wall, every timed step's wall and the profiled step's
device busy time.

``--kernels``: K4 (LSH chunk-attend forward) in bf16 at the longform
decoder's and encoder's LSH shapes and serving_fast's two, K6 (fused
LN + FFN) multiplying in bf16 at the decoder's and encoder's FFN, and the
LSH path's bucket sort ``rtts_torch.attention.lsh._sort_by_bucket`` at the
four bucket shapes of those steps (K7 where the checkout has it on the
path, else ``torch.sort`` + ``torch.argsort``).  Each: ms by CUDA events
over back-to-back calls after a warm-up, and device ms from
``torch.profiler`` (K4 and K6: every kernel whose name holds
``lsh_attend_fwd`` or ``ffn_fused``, so the cast and the main kernel of K6
count together; the sort: every kernel of the call).  The JSON line holds
each run's times by kernel and shape.

Prints every run's lines prefixed by its label, then the JSON line.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys

_HEAD = """
import sys
import torch
sys.path.insert(0, {root!r})
import chip_smoke as S
S.phase_device()
S.phase_build()
"""
_STEPS = _HEAD + """
from rtts_torch.models import reformer_tts as M
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
_KERNELS = _HEAD + """
from rtts_torch.ops.chunked_ffn import ffn_fused
from rtts_torch.ops.lsh_attention import lsh_attend_fwd
bf = torch.bfloat16
lsh = [S._LSH_DECODER, S._LSH_ENCODER] + [n for n in S.LSH_CASES
                                          if n.startswith("serving_fast")]
for name in lsh:
    (q, k, v, _), pos, valid, _, opts = S._lsh_case(*S.LSH_CASES[name], bf)
    fn = lambda: lsh_attend_fwd(q, k, v, pos, valid, *opts)
    S._events_ms(fn, 20)
    ms = S._events_ms(fn, 100)
    dev = S._device_ms(fn, 50, ("lsh_attend_fwd",))
    print(f"[ab-kernels] K4 {{name}}: {{ms:.4f}} ms (device {{dev:.4f}})")
    del q, k, v, pos, valid
for name in list(S.K6_CASES)[:2]:
    x, params, act = S._k6_case(*S.K6_CASES[name])
    fn = lambda: ffn_fused(x, *params, act, bf)
    S._events_ms(fn, 10)
    ms = S._events_ms(fn, 50)
    dev = S._device_ms(fn, 20, ("ffn_fused",))
    print(f"[ab-kernels] K6 {{name}}: {{ms:.4f}} ms (device {{dev:.4f}})")
from rtts_torch.attention import lsh as TL
for shape in ((2, 8, 4, 8192), (2, 8, 4, 1024), (8, 8, 4, 1024),
              (8, 8, 4, 256)):
    g = torch.Generator().manual_seed(S.SEED_DATA)
    buckets = torch.randint(0, TL.auto_num_buckets(shape[-1], 64), shape,
                            generator=g).cuda()
    fn = lambda: TL._sort_by_bucket(buckets)
    S._events_ms(fn, 20)
    ms = S._events_ms(fn, 100)
    dev = S._device_ms(fn, 50)
    print(f"[ab-kernels] K7 sort {{shape}}: {{ms:.4f}} ms (device {{dev:.4f}})")
"""

# the serving_fast variants read, by their label in the phase's lines
_VARIANTS = "(reversible \\+ chunked FFN \\(as shipped\\)|reversible \\+ K6)"
_STEP = re.compile(r"^\[(train-timing|train-lsh-timing|train-rev-timing)\] "
                   r"(?:" + _VARIANTS + r": )?train step .*"
                   r"walls \[([0-9., ]+)\] s; best ([0-9.]+) s")
_BUSY = re.compile(r"^\[(train-timing|train-lsh-timing|train-rev-timing)\] "
                   r"profile of one (?:" + _VARIANTS + r" )?step: wall [0-9.]+ "
                   r"s, device busy ([0-9.]+) s")
_KERNEL = re.compile(r"^\[ab-kernels\] (K[467]) (.+): ([0-9.]+) ms "
                     r"\(device ([0-9.]+)\)$")


def _key(hit) -> str:
    """The phase's tag, with " K6" for serving_fast's K6 variant."""
    return hit.group(1) + (" K6" if hit.group(2) == "reversible + K6" else "")


def _read_steps(line: str, found: dict) -> None:
    hit = _STEP.match(line)
    if hit:
        found["best_step_s"].setdefault(_key(hit), []).append(
            float(hit.group(4)))
        found["step_walls_s"].setdefault(_key(hit), []).extend(
            float(w) for w in hit.group(3).split(","))
    hit = _BUSY.match(line)
    if hit:
        found["device_busy_s"].setdefault(_key(hit), []).append(
            float(hit.group(3)))


def _read_kernels(line: str, found: dict) -> None:
    hit = _KERNEL.match(line)
    if hit:
        found["times"].setdefault(f"{hit.group(1)} {hit.group(2)}", []).append(
            {"ms": float(hit.group(3)), "device_ms": float(hit.group(4))})


# what each mode runs, how it reads a line, and the JSON line's keys
_MODES = {"steps": (_STEPS, _read_steps,
                    ("best_step_s", "step_walls_s", "device_busy_s")),
          "kernels": (_KERNELS, _read_kernels, ("times",))}


def main(argv) -> int:
    mode = "kernels" if "--kernels" in argv else "steps"
    args = [a for a in argv[1:] if a != "--kernels"]
    if len(args) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    run, read, keys = _MODES[mode]
    cycles = int(args[2]) if len(args) == 3 else 1
    roots = {"A": pathlib.Path(args[0]).resolve(),
             "B": pathlib.Path(args[1]).resolve()}
    found = {label: {key: {} for key in keys} for label in roots}
    for label in "ABBA" * cycles:
        root = roots[label]
        proc = subprocess.run([sys.executable, "-c", run.format(root=str(root))],
                              cwd=root, capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            print(f"{label} {line}")
            read(line, found[label])
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            print(f"{label} ({root}) exited {proc.returncode}", file=sys.stderr)
            return 1
    print(json.dumps({**{key: {label: found[label][key] for label in roots}
                         for key in keys},
                      "roots": {k: str(v) for k, v in roots.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
