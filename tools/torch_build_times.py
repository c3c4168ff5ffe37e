"""Where the CUDA kernels' build time goes: each library of the PyTorch
port compiled whole (one ``nvcc`` a source) and then in its parts (one
``nvcc -c`` a kernel or a route, ``ops/_build.py``'s ``PARTS``), each way
with every ``nvcc`` started together, as ``chip_smoke.py`` does.

For each way it prints the wall time until every library is built and,
for each ``nvcc``, the seconds of its compiler stages (``nvcc --time``:
cicc, ptxas and the host compiler's steps).  Each way builds into a
temporary directory of its own (removed after), so nothing is reused
between them.

Run on a host with ``nvcc`` (the CUDA card is not used) from the repo
root::

    python tools/torch_build_times.py [--ways whole,parts]

The last line of standard output is one JSON object with every reading.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def stage_seconds(path: str) -> dict:
    """``{stage: seconds}`` from one ``nvcc --time`` file."""
    out: dict = {}
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    for row in rows[1:]:
        cells = [c.strip() for c in row]
        if len(cells) < 8 or cells[7] != "ms":
            continue
        out[cells[1]] = out.get(cells[1], 0.0) + float(cells[6]) / 1e3
    return out


def build_once(way: str) -> dict:
    """Every library built ``way`` ("whole" or "parts") into a fresh
    directory; returns the wall seconds and each nvcc's stage seconds."""
    from neuronx_distributed_tpu_torch.ops import _build

    saved = (_build.BUILD_DIR, dict(_build.PARTS), _build._nvcc)
    work = tempfile.mkdtemp(prefix=f"nxd_build_{way}_")
    runs = []

    def timed(args):
        label = " ".join([os.path.basename(args[-1])]
                         + [a for a in args if a.startswith("-D")])
        path = os.path.join(work, f"time{len(runs)}.csv")
        runs.append((label, path))
        return saved[2](["--time", path, *args])

    try:
        _build.BUILD_DIR = os.path.join(work, "build")
        if way == "whole":
            _build.PARTS.clear()
        _build._nvcc = timed
        t0 = time.perf_counter()
        _build.build_all()
        wall = time.perf_counter() - t0
        stages = {label: stage_seconds(path) for label, path in runs
                  if os.path.exists(path)}
    finally:
        _build.BUILD_DIR = saved[0]
        _build.PARTS.clear()
        _build.PARTS.update(saved[1])
        _build._nvcc = saved[2]
        shutil.rmtree(work, ignore_errors=True)
    return {"wall_s": wall, "nvcc": stages}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ways", default="whole,parts",
                    help="comma-separated: whole, parts")
    args = ap.parse_args()
    out = {"cpus": os.cpu_count()}
    for way in args.ways.split(","):
        res = out[way] = build_once(way)
        print(f"{way}: every library built in {res['wall_s']:.1f} s",
              flush=True)
        for label, st in res["nvcc"].items():
            big = {k: round(v, 1) for k, v in st.items() if v >= 0.5}
            print(f"  {label}: {sum(st.values()):.1f} s; {big}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
