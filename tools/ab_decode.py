#!/usr/bin/env python3
"""Time the base.yaml kv_full decode of two checkouts of this repo on one
NVIDIA GPU, in the order A B B A.

    python3 tools/ab_decode.py DIR_A DIR_B [CYCLES] [--frames N]
        [--cache compute|float8_e4m3fn]

CYCLES (default 2) repeats the order A B B A.  Each run is a process of its
own that imports the ``chip_smoke.py`` of its checkout (``base_config``,
``_bench_inputs``) and times ``decode_greedy`` at b8 x 256 random tokens x
``--frames`` frames (default 512), bf16, the decode caches in ``--cache``
(default the compute dtype; ``float8_e4m3fn`` is serving_fast.yaml's),
stop threshold 2.0, with seeded random weights: ``--decodes`` decodes
(default 6), the first a warm-up.  Each run then takes the device time of
one decoder layer's kv_full self-attention step (``_self_attn_step``) over
a whole cache of ``--frames`` positions at several steps t, from CUDA graph
replays of 20 calls (no host cost inside a replay; the layer's step makes
its own position masks, which the decode makes once a step for all its
layers).  The kernel library is built once in DIR_B and copied to DIR_A:
use it only when both checkouts hold the same ``rtts_torch/csrc``.  Prints
each run's walls, median and best, and the step's device microseconds.
"""

from __future__ import annotations

import argparse
import pathlib
import shutil
import subprocess
import sys

# one run: its checkout's port and chip_smoke helpers, from its directory;
# argv: tag, frames, cache dtype, decodes
CHILD = r"""
import sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from rtts_torch.infer import decode as TD
from rtts_torch.models import reformer_tts as M
tag, frames, cache, n_dec = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    int(sys.argv[4])
cfg = cs.base_config(**({} if cache == "compute"
                        else {"kv_cache_dtype": cache}))
tts = TD._precast_weights(M.init(cfg.model, torch.Generator().manual_seed(0),
                                 "cuda"), torch.bfloat16)
tok, mask = cs._bench_inputs(cfg, 8, 256)
with torch.no_grad():
    mem = M.encode(tts, cfg.model, tok, mask)
walls = []
for i in range(n_dec):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    TD.decode_greedy(tts, cfg.model, mem, mask, max_frames=frames,
                     stop_threshold=2.0,
                     generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
w = sorted(walls[1:])
print(f"RESULT {tag} walls {[round(x, 4) for x in walls[1:]]} "
      f"median {w[len(w) // 2]:.4f} best {w[0]:.4f}", flush=True)

# one layer's self-attention step at step t over a whole cache of `frames`
mcfg, cdt = cfg.model, torch.bfloat16
kdt = TD._kv_dtype(mcfg, cdt)
a = mcfg.decoder.attention
p = tts.decoder.layers[0].f.attn
g = torch.Generator(device="cuda").manual_seed(1)
shape = (8, frames, a.num_heads, a.head_dim)
k = torch.randn(shape, generator=g, device="cuda").to(kdt)
v = torch.randn(shape, generator=g, device="cuda").to(kdt)
h = torch.randn((8, mcfg.decoder.d_model), generator=g,
                device="cuda").to(cdt)
us = {}
with torch.no_grad():
    for t in (0, frames // 4, frames // 2, 3 * frames // 4, frames - 1):
        def call():
            TD._self_attn_step(p, h, k, v, t, a.num_heads, cdt)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(20):
                call()
        graph.replay()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(10):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        us[t] = round(start.elapsed_time(end) * 1e3 / 200, 2)
        del graph
print(f"STEP {tag} one layer's self-attention step, device us by t: {us}",
      flush=True)
"""


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("cycles", nargs="?", type=int, default=2)
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--cache", default="compute")
    ap.add_argument("--decodes", type=int, default=6)
    args = ap.parse_args(argv[1:])
    # the kernel sources are the same in both trees: build once, share it
    subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, "
                    "'.'); from rtts_torch.ops import _build; "
                    "_build.library()"], cwd=args.b, check=True)
    src = pathlib.Path(args.b) / "build" / "rtts_torch"
    dst = pathlib.Path(args.a) / "build" / "rtts_torch"
    dst.mkdir(parents=True, exist_ok=True)
    for lib in src.glob("*.so"):
        shutil.copy(lib, dst / lib.name)
    print(f"kv_full b8 x {args.frames} frames, cache {args.cache}",
          flush=True)
    for _ in range(args.cycles):
        for tree, tag in ((args.a, "A"), (args.b, "B"), (args.b, "B"),
                          (args.a, "A")):
            out = subprocess.run(
                [sys.executable, "-c", CHILD, tag, str(args.frames),
                 args.cache, str(args.decodes)],
                cwd=tree, capture_output=True, text=True)
            lines = [l for l in out.stdout.splitlines()
                     if l.startswith(("RESULT", "STEP"))]
            print("\n".join(lines) if len(lines) == 2
                  else "\n".join(lines + [out.stderr[-2000:]]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
