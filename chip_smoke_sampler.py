#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s seconds go: the script under a wall-clock
stack sampler.

    python3 chip_smoke_sampler.py [--out FILE] [chip_smoke.py's arguments]

Run it from the root of the repository, as ``chip_smoke.py``.  A thread
reads the main thread's stack every ``DT`` seconds and adds ``DT`` to
three counts: the innermost line of ``chip_smoke.py`` (keyed with its
phase function), the innermost frame of all (file and function), and
the outermost frame in ``mmlspark_tpu_torch`` or ``torch.profiler`` (the
entry point the script called).  At the end it writes the wall time and
the counts, largest first, to ``--out`` (default
``chip_smoke_samples.json``) as JSON.  The script's output and exit code
pass through unchanged.
"""

import collections
import json
import os
import sys
import threading
import time

#: seconds between two samples
DT = 0.2


def _sample(main_tid, counts, stop):
    by_line, by_leaf, by_entry = counts
    while not stop.is_set():
        time.sleep(DT)
        frame = sys._current_frames().get(main_tid)
        stack = []
        while frame is not None:
            stack.append((frame.f_code.co_filename, frame.f_code.co_name,
                          frame.f_lineno))
            frame = frame.f_back
        ours = [f for f in stack if f[0].endswith("chip_smoke.py")]
        phase = next((f[1] for f in reversed(ours)
                      if f[1].startswith("phase_")), "?")
        inner = ours[0] if ours else ("?", "?", 0)
        by_line[f"{phase} {inner[1]}:{inner[2]}"] += DT
        if stack:
            leaf = stack[0]
            by_leaf[f"{phase} {os.path.basename(leaf[0])}:{leaf[1]}"] += DT
        entry = [f for f in stack if "mmlspark_tpu_torch" in f[0]
                 or "torch/profiler" in f[0]]
        if entry:
            path, fn, line = entry[-1]
            by_entry[f"{phase} {os.path.relpath(path)}:{fn}:{line}"] += DT


def main(argv) -> int:
    out = "chip_smoke_samples.json"
    if argv[:1] == ["--out"]:
        out, argv = argv[1], argv[2:]
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    counts = tuple(collections.Counter() for _ in range(3))
    stop = threading.Event()
    sampler = threading.Thread(
        target=_sample, args=(threading.get_ident(), counts, stop),
        daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        return chip_smoke.main(argv)
    finally:
        stop.set()
        sampler.join()
        with open(out, "w") as fh:
            json.dump({"wall_s": time.perf_counter() - t0,
                       "by_line": counts[0].most_common(),
                       "by_leaf": counts[1].most_common(),
                       "by_entry": counts[2].most_common()}, fh, indent=0)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
