#!/usr/bin/env python3
"""The level-histogram kernel of two checkouts, timed in turns on one
CUDA card.

    python3 tools/torch_hist_ab.py [--plane f32|q16|q8] ROOT_A ROOT_B

Each ROOT is a checkout of this repository. Every measurement runs in a
process of its own that imports ``mmlspark_tpu_torch`` from its root
(building that root's kernels), in the order A, B, B, A, so that two
versions of the kernel are compared on one card within one call. Each
process times the plane's histogram at the HIGGS bench shape
(N=2,000,000, F=28, B=255, 90% live rows) for every level width of a
depth-6 tree: ``hist_cuda.level_histogram`` on float32 stats (``f32``,
the default; the inputs of ``chip_smoke.py``'s phase ``kernel``) or
``hist_cuda.level_histogram_quant`` on int16 (``q16``) or int8 (``q8``)
stats (made as phase ``kernel_quant`` makes them). Per width it takes the
median CUDA-event time of 20 calls, and their sum, the time per tree; a
SHA-256 of every width's output, so that two roots can be seen to
compute the same bits; and it counts each atomic opcode in the SASS of
the root's built library (``cuobjdump -sass``), which shows whether a
shared add is native (``ATOMS.ADD``) or a CAS loop
(``ATOMS.CAST.SPIN``). It prints one JSON line per measurement with the
card's name and power limit; a last line holds the times per root and
whether every root gave the same digests.
"""

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

N, F, B = 2_000_000, 28, 255
WIDTHS = (1, 2, 4, 8, 16, 32)
REPS = 20
PLANES = {"f32": None, "q16": ("int16", 32000), "q8": ("int8", 120)}


def measure(root, plane):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.native import bindings
    if not H.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {H.__file__}, not from {root}")
    dev = torch.device("cuda")
    if plane == "f32":
        gen = torch.Generator(device=dev).manual_seed(0)
        binned = torch.randint(0, B, (N, F), generator=gen, device=dev,
                               dtype=torch.uint8)
        live = (torch.rand(N, generator=gen, device=dev) < 0.9).float()
        g = torch.randn(N, generator=gen, device=dev)
        h = torch.rand(N, generator=gen, device=dev) * 0.9 + 0.1
        library = "level_hist"

        def call(local, width):
            return H.level_histogram(binned, g, h, live, local, width, F, B)
    else:
        dtype_name, qmax = PLANES[plane]
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device=dev).manual_seed(1)
        binned = torch.randint(0, B, (N, F), generator=gen, device=dev,
                               dtype=torch.uint8)
        live = (torch.rand(N, generator=gen, device=dev) < 0.9).float()
        g = torch.round(torch.randn(N, generator=gen, device=dev)
                        .clamp(-4, 4) * (qmax / 4)).to(dtype)
        h = torch.round(torch.rand(N, generator=gen, device=dev)
                        * qmax).to(dtype)
        gsi = torch.full((), 2.0 ** -12, device=dev)
        hsi = torch.full((), 2.0 ** -14, device=dev)
        library = "level_hist_quant"

        def call(local, width):
            return H.level_histogram_quant(binned, g, h, live, local, width,
                                           F, B, gsi, hsi)
    per_width, digest = {}, hashlib.sha256()
    for width in WIDTHS:
        local = torch.randint(0, width, (N,), generator=gen, device=dev)
        digest.update(call(local, width).cpu().numpy().tobytes())
        for _ in range(3):
            call(local, width)
        pairs = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(local, width)
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
                           str(bindings.library_path(library))],
                          capture_output=True, text=True, timeout=120).stdout
    atomics = {}
    for op in re.findall(r"\b((?:ATOMS|ATOM|RED)\.[A-Z0-9.]+)", sass):
        atomics[op] = atomics.get(op, 0) + 1
    print(json.dumps({"root": root, "plane": plane, "card": smi,
                      "ms_per_width": per_width,
                      "ms_per_tree": sum(per_width.values()),
                      "sha256": digest.hexdigest(),
                      "sass_atomics": atomics}), flush=True)


def main(argv):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--plane", choices=tuple(PLANES), default="f32")
    parser.add_argument("--measure", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("roots", nargs="+")
    args = parser.parse_args(argv[1:])
    if args.measure:
        measure(args.roots[0], args.plane)
        return 0
    if len(args.roots) != 2:
        parser.error("give two roots")
    a, b = args.roots
    times = {a: [], b: []}
    digests = set()
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--measure", "--plane", args.plane, root],
                             capture_output=True, text=True, check=True,
                             timeout=900)
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        times[root].append(line["ms_per_tree"])
        digests.add(line["sha256"])
    print(json.dumps({"plane": args.plane,
                      "ms_per_tree": {r: sorted(t) for r, t in times.items()},
                      "same_bits": len(digests) == 1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
