#!/usr/bin/env python3
"""How many kernel launches does torch.profiler record as the process ages?

    python3 tools/profiler_drops.py [SECONDS]

For SECONDS (default 300) of one process's life on the card, once every
round (about 30 s): ten profiles of 20 back-to-back bf16 2048 x 2048
matmuls, five as they are and five with 50 ms host sleeps inside the
profile before the launches and after the synchronize (a pad that would
keep the kernels inside the profile's window if the records were cut by
a drift of clock against window).  Between rounds the card runs matmuls
outside any profile.  Each round prints the launches each profile kept
(20 is all) and the gap from the first launch's host call to its kernel's
start (us), and the last line is one JSON object of every round.
chip_smoke.py's device times (``_device_ms``) read such profiles, and
take them again, or time by CUDA events, when one kept none.
"""
import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

CALLS = 20
PAD_S = 0.05


def _profiled(fn, pad: float):
    """-> (launches recorded, first kernel start - first launch call, us)
    of one profile of CALLS calls of ``fn``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    events = prof.events()
    kernels = sorted(e.time_range.start for e in events
                     if e.device_type == DeviceType.CUDA)
    launches = sorted(e.time_range.start for e in events
                      if e.device_type == DeviceType.CPU
                      and "LaunchKernel" in e.name)
    gap = (round(kernels[0] - launches[0], 1) if kernels and launches
           else None)
    return len(kernels), gap


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_drops: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 300.0
    a = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16)
    fn = lambda: a @ a  # noqa: E731
    t0 = time.time()
    rounds = []
    while time.time() - t0 < seconds:
        age = round(time.time() - t0, 1)
        got = {"none": [_profiled(fn, 0.0) for _ in range(5)],
               "pad": [_profiled(fn, PAD_S) for _ in range(5)]}
        row = {"age_s": age, **{k: [n for n, _ in v] for k, v in got.items()},
               "gap_us": [g for v in got.values() for _, g in v]}
        rounds.append(row)
        print(f"[profiler-drops] age {age} s: launches kept of {CALLS}, as "
              f"they are {row['none']}, padded {row['pad']}; first launch "
              f"to its kernel {row['gap_us']} us", flush=True)
        end = time.time() + 25
        while time.time() < end:
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.2)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    print(json.dumps({"calls": CALLS, "pad_s": PAD_S, "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
