#!/usr/bin/env python3
"""Time the base.yaml kv_full decode of two checkouts of this repo on one
NVIDIA GPU, in the order A B B A.

    python3 tools/ab_decode.py DIR_A DIR_B [CYCLES]

CYCLES (default 2) repeats the order A B B A.  Each run is a process of its
own that imports the ``chip_smoke.py`` of its checkout (``base_config``,
``_bench_inputs``) and times ``decode_greedy`` at b8 x 256 random tokens x
512 frames, bf16, stop threshold 2.0, with seeded random weights: six
decodes, the first a warm-up.  The kernel library is built once in DIR_B
and copied to DIR_A: use it only when both checkouts hold the same
``rtts_torch/csrc``.  Prints each run's walls, median and best.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys

# one run: its checkout's port and chip_smoke helpers, from its directory
CHILD = r"""
import sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from rtts_torch.infer.decode import decode_greedy, _precast_weights
from rtts_torch.models import reformer_tts as M
cfg = cs.base_config()
tts = _precast_weights(M.init(cfg.model, torch.Generator().manual_seed(0),
                              "cuda"), torch.bfloat16)
tok, mask = cs._bench_inputs(cfg, 8, 256)
with torch.no_grad():
    mem = M.encode(tts, cfg.model, tok, mask)
walls = []
for i in range(6):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_greedy(tts, cfg.model, mem, mask, max_frames=512,
                  stop_threshold=2.0,
                  generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
w = sorted(walls[1:])
print(f"RESULT {sys.argv[1]} walls {[round(x, 4) for x in walls[1:]]} "
      f"median {w[2]:.4f} best {w[0]:.4f}")
"""


def main(argv) -> int:
    a, b = argv[1], argv[2]
    cycles = int(argv[3]) if len(argv) > 3 else 2
    # the kernel sources are the same in both trees: build once, share it
    subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, "
                    "'.'); from rtts_torch.ops import _build; "
                    "_build.library()"], cwd=b, check=True)
    src = pathlib.Path(b) / "build" / "rtts_torch"
    dst = pathlib.Path(a) / "build" / "rtts_torch"
    dst.mkdir(parents=True, exist_ok=True)
    for lib in src.glob("*.so"):
        shutil.copy(lib, dst / lib.name)
    for _ in range(cycles):
        for tree, tag in ((a, "A"), (b, "B"), (b, "B"), (a, "A")):
            out = subprocess.run([sys.executable, "-c", CHILD, tag], cwd=tree,
                                 capture_output=True, text=True)
            lines = [l for l in out.stdout.splitlines()
                     if l.startswith("RESULT")]
            print(lines[0] if lines else out.stderr[-2000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
