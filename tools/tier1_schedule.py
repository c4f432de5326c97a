#!/usr/bin/env python3
"""Where does the tier-1 run's wall go?  Replays a run's junit XML through
pytest-xdist's ``--dist loadfile`` schedule.

    python3 tools/tier1_schedule.py RUN.xml [--workers 6] [--free PATTERN]

``loadfile`` makes each test file one unit of work, queues the files by
descending test count (ties in collection order), gives every worker one
file and then a second, and hands each worker that finishes its next
file from the queue.  Each file costs the sum of its tests' junit times
(setup, call and teardown; not the file's import), so the replay's wall
sits a little under the run's.  ``--free PATTERN`` sets every file whose
name holds PATTERN to cost nothing: what the wall would be without them.
Prints the test-seconds (all, and of the freed files), the replayed wall,
each file's start and end, and the last file to end.
"""
import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def file_costs(path: str):
    """-> ({file: test-seconds}, {file: tests}) in collection order."""
    cost, count = collections.OrderedDict(), collections.Counter()
    for case in ET.parse(path).iter("testcase"):
        name = case.get("classname").split(".")[-1]
        cost[name] = cost.get(name, 0.0) + float(case.get("time") or 0.0)
        count[name] += 1
    order = sorted(cost)                 # tests/ collects files by name
    return {f: cost[f] for f in order}, count


def replay(cost: dict, count, workers: int):
    """-> (wall, {file: start}, {file: end}) of the loadfile schedule."""
    queue = sorted(cost, key=lambda f: -count[f])    # stable: ties by name
    own = [[] for _ in range(workers)]
    for _ in range(2):                   # one file each, then a second
        for w in range(workers):
            if queue:
                own[w].append(queue.pop(0))
    running = [(cost[own[w][0]], w, own[w].pop(0))
               for w in range(workers) if own[w]]
    heapq.heapify(running)
    start = {f: 0.0 for _, _, f in running}
    end = {}
    while running:
        t, w, f = heapq.heappop(running)
        end[f] = t
        nxt = own[w].pop(0) if own[w] else (queue.pop(0) if queue else None)
        if nxt is not None:
            start[nxt] = t
            heapq.heappush(running, (t + cost[nxt], w, nxt))
    return max(end.values()), start, end


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("xml")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--free", default=None)
    args = ap.parse_args()
    cost, count = file_costs(args.xml)
    freed = 0.0
    if args.free:
        freed = sum(c for f, c in cost.items() if args.free in f)
        cost = {f: (0.0 if args.free in f else c) for f, c in cost.items()}
    wall, start, end = replay(cost, count, args.workers)
    print(f"test-seconds {sum(cost.values()) + freed:.1f} (freed {freed:.1f});"
          f" replayed wall {wall:.1f} s on {args.workers} workers")
    for f in sorted(start, key=start.get):
        print(f"  {f:40s} tests {count[f]:4d}  {cost[f]:7.1f} s  "
              f"start {start[f]:7.1f}  end {end[f]:7.1f}")
    last = max(end, key=end.get)
    print(f"last to end: {last} (started {start[last]:.1f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
