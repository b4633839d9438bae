#!/usr/bin/env python3
"""The float32 level-histogram kernel of two checkouts, timed in turns on
one CUDA card.

    python3 tools/torch_hist_ab.py ROOT_A ROOT_B

Each ROOT is a checkout of this repository. Every measurement runs in a
process of its own that imports ``mmlspark_tpu_torch`` from its root
(building that root's kernels), in the order A, B, B, A, so that two
versions of the kernel are compared on one card within one call. Each
process times ``hist_cuda.level_histogram`` on float32 stats at the
HIGGS bench shape (N=2,000,000, F=28, B=255, 90% live rows, the inputs of
``chip_smoke.py``'s phase ``kernel``) for every level width of a depth-6
tree: the median CUDA-event time of 20 calls per width, and their sum,
the time per tree; and it counts each atomic opcode in the SASS of the
root's built ``level_hist`` library (``cuobjdump -sass``), which shows
whether a 64-bit shared add is native or a CAS loop
(``ATOMS.CAST.SPIN.64``). It prints one JSON line per measurement with
the card's name and power limit; a last line holds the medians per
root.
"""

import json
import os
import re
import subprocess
import sys

N, F, B = 2_000_000, 28, 255
WIDTHS = (1, 2, 4, 8, 16, 32)
REPS = 20


def measure(root):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.native import bindings
    if not H.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {H.__file__}, not from {root}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    binned = torch.randint(0, B, (N, F), generator=gen, device=dev,
                           dtype=torch.uint8)
    live = (torch.rand(N, generator=gen, device=dev) < 0.9).float()
    gf = torch.randn(N, generator=gen, device=dev)
    hf = torch.rand(N, generator=gen, device=dev) * 0.9 + 0.1
    per_width = {}
    for width in WIDTHS:
        local = torch.randint(0, width, (N,), generator=gen, device=dev)
        for _ in range(3):
            H.level_histogram(binned, gf, hf, live, local, width, F, B)
        pairs = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            H.level_histogram(binned, gf, hf, live, local, width, F, B)
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        per_width[width] = float(np.median([s.elapsed_time(e)
                                            for s, e in pairs]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cuobjdump = os.path.join(os.path.dirname(bindings.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(bindings.library_path("level_hist"))],
                          capture_output=True, text=True, timeout=120).stdout
    atomics = {}
    for op in re.findall(r"\b((?:ATOMS|ATOM|RED)\.[A-Z0-9.]+)", sass):
        atomics[op] = atomics.get(op, 0) + 1
    print(json.dumps({"root": root, "card": smi,
                      "ms_per_width": per_width,
                      "ms_per_tree": sum(per_width.values()),
                      "sass_atomics": atomics}), flush=True)


def main(argv):
    if len(argv) == 3 and argv[1] == "--measure":
        measure(argv[2])
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = argv[1], argv[2]
    times = {a: [], b: []}
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--measure", root], capture_output=True,
                             text=True, check=True, timeout=900)
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        times[root].append(json.loads(line)["ms_per_tree"])
    print(json.dumps({"ms_per_tree": {r: sorted(t) for r, t in
                                      times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
