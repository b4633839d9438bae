#!/usr/bin/env python3
"""The quantized level-histogram kernel at other launch configurations,
timed on one CUDA card.

    python3 tools/torch_hist_quant_configs.py [--plane q16|q8]

Builds this checkout's ``csrc/level_hist_quant.cu`` once per
configuration, its constants ``kThreads`` (threads per CTA),
``kCtasPerSm`` (CTAs per SM its launch bounds ask for), ``kChunk`` (rows
staged at once) and ``kStages`` (chunks in the staging ring) replaced,
into ``mmlspark_tpu_torch/build/configs/``, and runs each through
``hist_cuda.level_histogram_quant`` at the HIGGS bench shape (N=2,000,000,
F=28, B=255, 90% live rows, stats made as ``chip_smoke.py``'s phase
``kernel_quant`` makes them) for every level width of a depth-6 tree.
Per configuration and width: bitwise against the plain version, and the
device time of one call (CUDA events around 20 calls queued behind a
spin kernel, median of 3 batches; ``chip_smoke.device_ms``'s method);
their sum is the time per tree. The configurations run in two rounds, in
order and then reversed, in one process on one card. One JSON line per
configuration and round, with the card's name and power limit; a last
line holds both rounds' times per tree.
"""

import argparse
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import time

N, F, B = 2_000_000, 28, 255
WIDTHS = (1, 2, 4, 8, 16, 32)
REPS, BATCHES = 20, 3
QUANTS = {"q16": ("int16", 32000), "q8": ("int8", 120)}
# (threads per CTA, CTAs per SM, rows per chunk, stages): one CTA of 1,024
# threads with a ring of 2, 3 or 4 chunks, or two CTAs of 512 threads per
# SM in the shared memory the int32 cells leave free
CONFIGS = ((1024, 1, 256, 2), (1024, 1, 256, 4), (1024, 1, 512, 2),
           (1024, 1, 512, 3), (1024, 1, 1024, 2), (1024, 1, 1536, 2),
           (512, 2, 192, 2), (512, 2, 128, 3))
CONSTANTS = ("kThreads", "kCtasPerSm", "kChunk", "kStages")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_ms(torch, fn):
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


def build(bindings, configs):
    """One library per configuration, all ``nvcc`` started together:
    {config: path}."""
    source = (bindings.CSRC / "level_hist_quant.cu").read_text()
    out_dir = bindings.BUILD_DIR / "configs"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for cfg in configs:
        text = source
        for name, value in zip(CONSTANTS, cfg):
            text, hits = re.subn(rf"constexpr int {name} = \d+;",
                                 f"constexpr int {name} = {value};", text)
            if hits != 1:
                raise RuntimeError(f"{name} is not one constant of the source")
        stem = "level_hist_quant_" + "_".join(map(str, cfg))
        src = out_dir / f"{stem}.cu"
        src.write_text(text)
        lib = out_dir / f"lib{stem}.so"
        procs[cfg] = (lib, subprocess.Popen(
            [bindings.nvcc_path(), *bindings.NVCC_FLAGS, "-I",
             str(bindings.CSRC), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for cfg, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {cfg}:\n{log}")
        libs[cfg] = lib
    return libs


@contextlib.contextmanager
def configured(H, bindings, path, cfg):
    """``level_histogram_quant`` on the library at ``path``, its scratch
    sized for the configuration's chunk rows and stages."""
    lib = ctypes.CDLL(str(path))
    for fn_name, (argtypes, restype) in \
            bindings.SIGNATURES["level_hist_quant"].items():
        getattr(lib, fn_name).argtypes = argtypes
        getattr(lib, fn_name).restype = restype
    saved = bindings.load, H.QUANT_CHUNK_ROWS, H.QUANT_STAGES
    bindings.load, H.QUANT_CHUNK_ROWS, H.QUANT_STAGES = \
        (lambda name: lib), cfg[2], cfg[3]
    try:
        yield
    finally:
        bindings.load, H.QUANT_CHUNK_ROWS, H.QUANT_STAGES = saved


def main(argv):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--plane", choices=tuple(QUANTS), default="q16")
    args = parser.parse_args(argv[1:])
    sys.path.insert(0, ROOT)
    import torch

    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.native import bindings
    libs = build(bindings, CONFIGS)
    dev = torch.device("cuda")
    dtype_name, qmax = QUANTS[args.plane]
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
    cases = []
    for width in WIDTHS:
        local = torch.randint(0, width, (N,), generator=gen, device=dev)
        a = (binned, g, h, live, local, width, F, B, gsi, hsi)
        cases.append((width, a, H.level_histogram_quant_reference(*a)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    times = {cfg: [] for cfg in CONFIGS}
    for cfg in CONFIGS + CONFIGS[::-1]:
        with configured(H, bindings, libs[cfg], cfg):
            smem = H.quant_smem_bytes(F, B)
            per_width, bitwise = {}, True
            for width, a, plain in cases:
                bitwise &= bool(torch.equal(H.level_histogram_quant(*a),
                                            plain))
                per_width[width] = device_ms(
                    torch, lambda a=a: H.level_histogram_quant(*a))
        times[cfg].append(sum(per_width.values()))
        print(json.dumps({"plane": args.plane, "card": smi,
                          "config": dict(zip(CONSTANTS, cfg)),
                          "smem_bytes": smem,
                          "bitwise": bitwise, "device_ms": per_width,
                          "ms_per_tree": times[cfg][-1]}), flush=True)
    print(json.dumps({"plane": args.plane, "card": smi, "ms_per_tree": {
        "/".join(map(str, cfg)): t for cfg, t in times.items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
