#!/usr/bin/env python3
"""The histogram kernels' uint16 instances under other cell layouts and
chunk sizes, timed on one CUDA card.

    python3 tools/torch_hist_u16_layouts.py

Builds this checkout's ``csrc/level_hist.cu`` and
``csrc/level_hist_quant.cu`` once per variant into
``mmlspark_tpu_torch/build/layouts/``:

- ``bank_groups``: the sources as they are (``level_hist_common.cuh``:
  ``U16Cells``, feature fl owning g = 32 // fs banks of 32-word rows);
- ``odd_stride``: the cells of feature fl at ``fl * (tile_bins | 1) +
  bin``, so a warp's lanes fall on banks as their bins do;
- ``bank_groups_chunk512`` and ``odd_stride_chunk512``: the float32
  kernel staging 512 rows at once (``kChunk``; the quantized kernel as it
  is); with odd strides its 7-feature slices still fit at B = 1,023.

Each runs through ``hist_cuda.level_histogram`` (float32 stats) and
``level_histogram_quant`` (int16 stats) with ``hist_cuda``'s plans for
that layout, at N = 2,000,000 rows, 90% live, uint16 ids: F = 28 at B =
1,023 and 4,095, F = 27 at 1,023, and F = 28 at 1,023 with 90% of each
feature's rows in one bin of its own (``chip_smoke.py``'s ``HIST_U16``
cases), for every level width of a depth-6 tree. Per variant, case and
width: bitwise against the plain version, and the device time of one
call (CUDA events around 20 calls queued behind a spin kernel, median of
3 batches); their sum is the time per tree. The variants run in two
rounds, in order and then reversed, in one process on one card. One JSON
line per variant, plane and round, with the card's name and power limit
and the plans; a last line holds every round's times per tree.
"""

import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import time

N = 2_000_000
WIDTHS = (1, 2, 4, 8, 16, 32)
REPS, BATCHES = 20, 3
CASES = (("bench", 28, 1023), ("skewed", 28, 1023), ("bench", 28, 4095),
         ("odd_f", 27, 1023))
SKEW = 0.9
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ODD_STRIDE_CELLS = """struct U16Cells {
  int stride;
  __device__ U16Cells(int /*fs*/, int tile_bins) : stride(tile_bins | 1) {}
  __device__ __forceinline__ int at(int fl, int bin) const {
    return fl * stride + bin;
  }
};"""
ODD_STRIDE_PLANE = """__host__ __device__ inline int u16_plane_words(int f_slice, int tile_bins) {
  return (f_slice * (tile_bins | 1) + 1) & ~1;
}"""


def odd_stride_plane_words(f_slice, tile_bins):
    return (f_slice * (tile_bins | 1) + 1) & ~1


# variant: (replace the layout, float32 kernel's chunk rows)
VARIANTS = {"bank_groups": (False, 256), "odd_stride": (True, 256),
            "bank_groups_chunk512": (False, 512),
            "odd_stride_chunk512": (True, 512)}


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


def substitute(text, pattern, repl, what):
    text, hits = re.subn(pattern, lambda _: repl, text, flags=re.S)
    if hits != 1:
        raise RuntimeError(f"{what} is not one block of the source")
    return text


def build(bindings):
    """Both libraries per variant, all ``nvcc`` started together:
    {(variant, library): path}."""
    procs = {}
    for variant, (odd, chunk) in VARIANTS.items():
        out_dir = bindings.BUILD_DIR / "layouts" / variant
        out_dir.mkdir(parents=True, exist_ok=True)
        header = (bindings.CSRC / "level_hist_common.cuh").read_text()
        if odd:
            header = substitute(header, r"struct U16Cells \{.*?\n\};",
                                ODD_STRIDE_CELLS, "U16Cells")
            header = substitute(
                header, r"__host__ __device__ inline int u16_plane_words\(.*?\n\}",
                ODD_STRIDE_PLANE, "u16_plane_words")
        # the quoted include finds this copy beside the source first
        (out_dir / "level_hist_common.cuh").write_text(header)
        for name in ("level_hist", "level_hist_quant"):
            text = (bindings.CSRC / f"{name}.cu").read_text()
            if name == "level_hist":
                text = substitute(text, r"constexpr int kChunk = \d+;",
                                  f"constexpr int kChunk = {chunk};", "kChunk")
            src = out_dir / f"{name}.cu"
            src.write_text(text)
            lib = out_dir / f"lib{name}.so"
            procs[variant, name] = (lib, subprocess.Popen(
                [bindings.nvcc_path(), *bindings.NVCC_FLAGS, "-I",
                 str(bindings.CSRC), "-o", str(lib), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = lib
    return libs


@contextlib.contextmanager
def variant_of(H, bindings, libs, variant):
    """``hist_cuda`` on the variant's libraries, its plans and shared
    memory sized for the variant's layout and chunk rows."""
    odd, chunk = VARIANTS[variant]
    loaded = {}
    for name in ("level_hist", "level_hist_quant"):
        lib = ctypes.CDLL(str(libs[variant, name]))
        for fn_name, (argtypes, restype) in bindings.SIGNATURES[name].items():
            getattr(lib, fn_name).argtypes = argtypes
            getattr(lib, fn_name).restype = restype
        loaded[name] = lib
    saved = bindings.load, H.u16_plane_words, H.CHUNK_ROWS
    bindings.load = loaded.__getitem__
    if odd:
        H.u16_plane_words = odd_stride_plane_words
    H.CHUNK_ROWS = chunk
    try:
        yield
    finally:
        bindings.load, H.u16_plane_words, H.CHUNK_ROWS = saved


def make_case(torch, shape, f, b):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(b + f)
    ids = torch.randint(0, b, (N, f), generator=gen, device=dev,
                        dtype=torch.int32)
    if shape == "skewed":
        default = torch.randint(0, b, (1, f), generator=gen, device=dev,
                                dtype=torch.int32)
        ids = torch.where(torch.rand((N, f), generator=gen, device=dev)
                          < SKEW, default, ids)
    binned = ids.to(torch.int16).view(torch.uint16)
    live = (torch.rand(N, generator=gen, device=dev) < 0.9).float()
    g = torch.randn(N, generator=gen, device=dev)
    h = torch.rand(N, generator=gen, device=dev) * 0.9 + 0.1
    gq = torch.round(torch.randn(N, generator=gen, device=dev)
                     .clamp(-4, 4) * 8000).to(torch.int16)
    hq = torch.round(torch.rand(N, generator=gen, device=dev)
                     * 32000).to(torch.int16)
    locals_ = {w: torch.randint(0, w, (N,), generator=gen, device=dev)
               for w in WIDTHS}
    return binned, live, (g, h), (gq, hq), locals_


def main():
    sys.path.insert(0, ROOT)
    import torch

    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.native import bindings
    libs = build(bindings)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cases = {(shape, f, b): make_case(torch, shape, f, b)
             for shape, f, b in CASES}
    gsi = torch.full((), 2.0 ** -12, device="cuda")
    hsi = torch.full((), 2.0 ** -14, device="cuda")
    times = {}
    order = list(VARIANTS)
    for round_, variant in enumerate(order + order[::-1]):
        with variant_of(H, bindings, libs, variant):
            for plane in ("f32", "q16"):
                out = {}
                for (shape, f, b), (binned, live, fl, qs, locs) in \
                        cases.items():
                    per_width, bitwise = {}, True
                    for w, local in locs.items():
                        if plane == "f32":
                            args = (binned, *fl, live, local, w, f, b)
                            call, plain = (H.level_histogram,
                                           H.level_histogram_reference)
                        else:
                            args = (binned, *qs, live, local, w, f, b, gsi,
                                    hsi)
                            call, plain = (H.level_histogram_quant,
                                           H.level_histogram_quant_reference)
                        bitwise &= bool(torch.equal(call(*args), plain(*args)))
                        per_width[w] = device_ms(
                            torch, lambda c=call, a=args: c(*a))
                    key = f"{shape}_f{f}_b{b}"
                    out[key] = {"ms_per_tree": sum(per_width.values()),
                                "device_ms": per_width, "bitwise": bitwise,
                                "plan": (H.f32_plan if plane == "f32"
                                         else H.quant_plan)(f, b, 2)}
                    times.setdefault(f"{variant}/{plane}/{key}", []).append(
                        out[key]["ms_per_tree"])
                print(json.dumps({"variant": variant, "plane": plane,
                                  "round": round_ // len(order),
                                  "card": smi, "cases": out}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "ms_per_tree": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
