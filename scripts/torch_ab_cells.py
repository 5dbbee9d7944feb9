#!/usr/bin/env python3
"""Set side by side the cell-kernel rows (``chip_smoke.py`` phase 4) of
several runs, e.g. parent, change, change, parent in one call on one card.

    python scripts/torch_ab_cells.py parent1.log change1.log change2.log parent2.log

For every K3-K6 row key (kernel, dtype, (C, H, W), edges or op) it prints
one JSON line with each log's wrapper time (``ms``, CUDA events) and, where
the run measured it, its profiler ``device_ms``; then, per dtype and level,
each log's sum of the K3 times over the flagship's five blocks (one cell;
blocks that a run does not send to K3 are left out and counted).
"""
from __future__ import annotations

import json
import sys
from collections import defaultdict

FLAGSHIP_BLOCKS = {
    ("dil_conv_5x5", "sep_conv_3x3"), ("sep_conv_3x3", "dil_conv_3x3"), ("sep_conv_3x3", "sep_conv_3x3"),
    ("sep_conv_5x5", "sep_conv_5x5"), ("dil_conv_5x5", "sep_conv_5x5"),
}


def rows(path):
    with open(path) as f:
        for line in f:
            if line.startswith('{"phase": "cell_kernels"'):
                yield json.loads(line)


def main(paths):
    table = defaultdict(dict)
    cells = defaultdict(lambda: defaultdict(lambda: [0.0, 0.0, 0]))
    for i, path in enumerate(paths):
        for r in rows(path):
            what = tuple(r["edges"]) if "edges" in r else r["op"]
            key = (r["kernel"], r["dtype"], tuple(r["shape"]), what)
            table[key][i] = (r["ms"], r.get("device_ms"))
            if r["kernel"] == "block_stage" and what in FLAGSHIP_BLOCKS:
                acc = cells[(r["dtype"], tuple(r["shape"]))][i]
                acc[0] += r["ms"]
                acc[1] += r.get("device_ms") or 0.0
                acc[2] += 1
    for (kernel, dtype, shape, what), got in table.items():
        print(json.dumps({"kernel": kernel, "dtype": dtype, "shape": list(shape), "what": what,
                          "ms": [got.get(i, (None,))[0] for i in range(len(paths))],
                          "device_ms": [got.get(i, (None, None))[1] for i in range(len(paths))]}))
    for (dtype, shape), got in cells.items():
        print(json.dumps({"k3_per_cell": dtype, "shape": list(shape),
                          "ms": [got[i][0] for i in range(len(paths))],
                          "device_ms": [got[i][1] or None for i in range(len(paths))],
                          "k3_blocks": [got[i][2] for i in range(len(paths))]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
