#!/usr/bin/env python3
"""The float32 flash-attention kernel of two checkouts, timed in turns on
one CUDA card.

    python3 tools/torch_flash_ab.py ROOT_A ROOT_B

Each ROOT is a checkout of this repository. Every measurement runs in a
process of its own that imports ``mmlspark_tpu_torch`` from its root
(building that root's kernels), in the order A, B, B, A, so that two
versions of the kernel are compared on one card within one call. Each
process calls ``flash.flash_attention`` on float32 q, k, v at the repo's
attention A/B shape (b=4, n=2048, h=8, d=64; ``chip_smoke.py``'s
``FLASH_AB``), causal and not, and takes the device time of one call:
CUDA events around 20 calls queued behind a spin kernel, over 20, the
median of 3 batches (``chip_smoke.device_ms``'s method). It also prints
a SHA-256 of each output's bytes, so that two roots can be seen to
compute the same bits. It prints one JSON line per measurement with the
card's name and power limit; a last line holds the times per root and
whether every root gave the same digests.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

SHAPE = (4, 2048, 8, 64)
REPS = 20
BATCHES = 3


def device_ms(torch, fn):
    """Device time of one call of ``fn`` in ms: ``REPS`` calls enqueued
    behind a spin kernel, timed by CUDA events, median of ``BATCHES``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spin, times = 1 << 24, []
    while len(times) < BATCHES:
        held, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        held.record()
        torch.cuda._sleep(spin)
        start.record()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms >= held.elapsed_time(start):
            spin *= 4
            if spin > 1 << 30:
                raise RuntimeError("the host never enqueued a batch within "
                                   "the spin")
            continue
        times.append(start.elapsed_time(end) / REPS)
    return sorted(times)[len(times) // 2]


def measure(root):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from mmlspark_tpu_torch.parallel import flash as FL
    if not FL.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {FL.__file__}, not from {root}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(SHAPE, generator=gen, device="cuda")
               for _ in range(3))
    ms, digests = {}, {}
    for causal in (True, False):
        name = "causal" if causal else "non_causal"

        def call():
            return FL.flash_attention(q, k, v, causal=causal)
        out = call()
        torch.cuda.synchronize()
        digests[name] = hashlib.sha256(
            out.cpu().numpy().tobytes()).hexdigest()
        ms[name] = device_ms(torch, call)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "card": smi, "shape": list(SHAPE),
                      "device_ms": ms, "sha256": digests}), flush=True)


def main(argv):
    if len(argv) == 3 and argv[1] == "--measure":
        measure(argv[2])
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = argv[1], argv[2]
    times = {a: [], b: []}
    digests = set()
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--measure", root], capture_output=True,
                             text=True, check=True, timeout=900)
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        times[root].append(line["device_ms"])
        digests.add(json.dumps(line["sha256"], sort_keys=True))
    print(json.dumps({"device_ms": times,
                      "same_bits": len(digests) == 1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
