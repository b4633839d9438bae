#!/usr/bin/env python3
"""The PyTorch port's main path on one CUDA card, end to end.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``mmlspark_tpu_torch/csrc`` (nvcc,
sm_90a), then:

  1. device: the card's name and power limit, torch/CUDA versions,
     kernel build time and the ptxas report;
  2. kernel vs plain: the level-histogram kernel (float32 stats summed
     in fixed point) against its plain PyTorch version at the HIGGS
     bench shape (N=2,000,000, F=28, B=255) for every level width of a
     depth-6 tree — bitwise on integer-valued and on float stats, and
     bitwise between two launches — with CUDA-event timings of the
     kernel (an event pair per call, and ``device_ms``), the plain
     version and one float32 ``index_add_`` call, one call's device time
     by kernel (partition, histogram, dequantization), and the bound from
     bytes and operations;
  3. main path: ``BinMapper.fit`` / ``transform``, ``train`` (binary,
     num_leaves=63, max_depth=6, 20 trees) and ``predict_binned`` on the
     2M rows, with the kernel's launch count over the fit, the training
     logloss per tree, two fits bitwise equal, and fit / scoring rates;
  4. profile: a 5-tree bench-shape fit under torch.profiler — device
     time by kernel and the device's idle share;
  5. card vs CPU: the same fit at 100k rows and 5 trees on ``cuda`` and
     on ``cpu`` through the port;
  6. quantized kernel vs plain: the int16 (q16) and int8 (q8)
     level-histogram kernel against its plain version at the bench
     shape for every level width — bitwise, and bitwise between two
     launches — with CUDA-event timings of the kernel, the plain
     version and one int64 ``index_add_`` call, one call's device time
     by kernel (partition, histogram, dequantization), and the byte
     bound; the int32 window (q16, 40,000,000 rows of +32000 in bin 0,
     so a CTA's run in one node passes what an int32 cell holds:
     bitwise against the plain version and between two launches); and
     the atomic opcodes in the built kernel's SASS (native ``ATOMS.ADD``,
     no CAS loop);
  7. quantized main path: the 20-tree bench fit under
     ``MMLSPARK_TORCH_HIST_QUANT=q16`` (then q8), with the kernels'
     launch counts over each fit, the training logloss per tree, host
     syncs, two fits bitwise equal, and the fit rate; then the f32 and
     the q16 fit with ``MMLSPARK_TORCH_HIST_SUB=1``, and the kernels'
     device time per tree with subtraction off and on (torch.profiler);
  8. card vs CPU, quantized: the 100k-row 5-tree fit under q16 on
     ``cuda`` and on ``cpu``;
  9. flash kernels vs plain: ``csrc/flash_attn.cu`` (float32) and
     ``csrc/flash_attn_sm90.cu`` (every bfloat16 call: wgmma, TMA, a
     producer warp; in place, or on copies staged for TMA) against
     ``flash_attention_reference`` (TF32 off) at the repo's attention A/B
     shape (b=4, n=2048, h=8, d=64; ``tools/tpu_day.sh``), causal and
     not, in float32 and bfloat16, at d=16, 32, 33, 36, 96 and 128 (bf16;
     float32 at 16, 33, 64, 96 and 128), with cross and ragged lengths,
     scores far outside exp's range, a packed-qkv view, a (b, h, n, d)
     view and a misaligned view (staged) — within rtol 2e-4 / atol 2e-5
     in float32 and that plus one bf16 step in bfloat16, two launches
     bitwise equal, the route each case took (counter deltas) — with
     device times of the call, of its staging copies and of
     ``scaled_dot_product_attention``, CUDA-event timings of the plain
     version, the bound, and at the A/B shape the host's microseconds per
     call (200 calls, no synchronise);
 10. SDPA backends: ``scaled_dot_product_attention`` at the A/B shape
     (causal) in float32 and bfloat16 under each backend alone — which
     accept the call, their times, their max abs error against the plain
     version, and which one the default call matches bit for bit;
 11. attention path: ``fused_attention`` (causal) at the A/B shape in
     float32 and bfloat16 (and bfloat16 at d=32 and through a misaligned
     view, both on ``flash_attn_sm90.cu``, the second staged) and at b=1,
     n=16384, h=8, d=64 in both types, one kernel launch per call (of the
     route it expects; ``flash_attn.cu`` never for bfloat16), against
     ``blockwise_attention``, with the times of both (the flash-vs-
     blockwise A/B), and the refusal of inputs that require grad;
 12. attention, distributed: a one-rank NCCL group runs
     ``ring_attention`` and ``ulysses_attention`` (which launches the
     kernel through ``fused_attention``) against ``blockwise_attention``.

Each phase prints one JSON line. Any failure exits non-zero and prints
no result. Without a CUDA card it exits 2 at once. The last lines are
the kernel table, the ``nvidia-smi`` name/power line, and
``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

N, F, B = 2_000_000, 28, 255
WIDTHS = (1, 2, 4, 8, 16, 32)        # the six levels of a depth-6 tree
TREES = 20
REPS = 20
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and
# float32 outside the tensor cores (the histogram's adds; the quantized
# kernel's int32 adds are held to the same scalar rate)
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32_EPS = 2.0 ** -24
QUANTS = {"q16": ("int16", 32000), "q8": ("int8", 120)}
# attention: the repo's flash-vs-blockwise A/B (tools/tpu_day.sh:112-142)
# and its long-context length (ROUND4_NOTES.md:121: n=16384 "needs real
# chips"); dense tensor-core peaks: bfloat16 (the bf16 function's
# operation bound) and TF32 (a note beside the float32 bound)
FLASH_AB = (4, 2048, 8, 64)
FLASH_LONG = (1, 16384, 8, 64)
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(torch, fn, reps=REPS, warmup=3):
    """Median CUDA-event time of ``fn`` in ms over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in times]))


@contextlib.contextmanager
def knobs(quant="off", sub="0"):
    """The port's histogram knobs for the fits inside the block."""
    names = {"MMLSPARK_TORCH_HIST_QUANT": quant,
             "MMLSPARK_TORCH_HIST_SUB": sub}
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(names)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def count_syncs(torch, fn):
    """Host syncs made by ``fn()``: CUDA sync debug mode warns once for
    every synchronizing call."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def device_ms_by_kernel(torch, fn):
    """(wall ms, {kernel name: device ms}) of ``fn()`` under
    torch.profiler, names without template arguments."""
    wall_ms, by_name, _ = profile_ms(torch, fn)
    return wall_ms, by_name


def kernel_name(name):
    """A profiled kernel's name without namespace noise or template
    arguments."""
    base = name.replace("(anonymous namespace)::", "")
    return re.sub(r"[<(].*$", "", base).strip()


def profile_ms(torch, fn):
    """(wall ms, {kernel name: device ms}, {host op: self ms}) of
    ``fn()`` under torch.profiler, kernel names without template
    arguments."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            name = kernel_name(e.name)
            by_name[name] = by_name.get(name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    host = {e.key: e.self_cpu_time_total / 1e3 for e in prof.key_averages()
            if e.self_cpu_time_total > 0}
    return wall_ms, by_name, host


def device_ms(torch, fn, reps=REPS, warmup=3, batches=3):
    """Device time of one call of ``fn`` in ms, back to back: a spin
    kernel (``torch.cuda._sleep``) holds the stream while the host
    enqueues ``reps`` calls, so the CUDA events around them time the
    device's work alone, with no host time between calls (the device's
    own gaps between kernels count). If the host took longer to enqueue
    than the spin lasted, the batch is run again with a longer spin.
    The median of ``batches`` batches. Unlike an event pair around each
    call, it does not grow when the host's work per call outlasts the
    device's; unlike summing a profiler's kernel records, it cannot
    miss a kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin, times = 1 << 24, []
    while len(times) < batches:
        held, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        held.record()
        torch.cuda._sleep(spin)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms >= held.elapsed_time(start):
            spin *= 4
            if spin > 1 << 30:
                raise AssertionError("the host never enqueued a batch within "
                                     "the spin")
            continue
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


# the kernels of the histogram wrappers: the histograms, the float32
# plane's partition (plan_count, plan_scan, plan_scatter), and the
# dequantization
HIST_KERNELS = ("level_hist", "plan_", "dequantize")


def hist_device_ms(by_name):
    return sum(v for k, v in by_name.items()
               if any(h in k for h in HIST_KERNELS))


def top(by_name, k):
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:k])


BOOSTER_ARRAYS = ("split_feature", "threshold_bin", "threshold_value",
                  "node_value", "count", "tree_weights")


def boosters_equal(a, b):
    return not arrays_differing(a, b)


def arrays_differing(a, b):
    return [k for k in BOOSTER_ARRAYS
            if not np.array_equal(getattr(a, k), getattr(b, k))]


def phase_device(ctx):
    import torch

    from mmlspark_tpu_torch.native import bindings
    t0 = time.perf_counter()
    reports = bindings.build()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln]
             for name, log in reports.items()}
    ctx["kind"] = torch.cuda.get_device_name(0)
    ctx["smi"] = nvidia_smi_line()
    return {"nvidia_smi": ctx["smi"], "torch": torch.__version__,
            "cuda": torch.version.cuda, "kind": ctx["kind"],
            "count": torch.cuda.device_count(),
            "kernel_build_s": build_s, "ptxas": ptxas}


def phase_kernel(ctx):
    """Level-histogram kernel vs its plain version at the bench shape:
    the fixed-point sums are the same bits in any order, so bitwise on
    every stat, and between two launches."""
    import torch

    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    binned = torch.randint(0, B, (N, F), generator=gen, device=dev,
                           dtype=torch.uint8)
    live = (torch.rand(N, generator=gen, device=dev) < 0.9).float()
    # integer-valued stats in [-4, 4]: every partial sum is an integer of
    # magnitude <= 4N = 8e6 < 2^24, exact in float32 in any order
    gi = torch.randint(-4, 5, (N,), generator=gen, device=dev).float()
    hi = torch.randint(0, 5, (N,), generator=gen, device=dev).float()
    gf = torch.randn(N, generator=gen, device=dev)
    hf = torch.rand(N, generator=gen, device=dev) * 0.9 + 0.1
    rows = []
    for width in WIDTHS:
        local = torch.randint(0, width, (N,), generator=gen, device=dev)
        args = (width, F, B)
        k_int = H.level_histogram(binned, gi, hi, live, local, *args)
        p_int = H.level_histogram_reference(binned, gi, hi, live, local, *args)
        k = H.level_histogram(binned, gf, hf, live, local, *args)
        k2 = H.level_histogram(binned, gf, hf, live, local, *args)
        p = H.level_histogram_reference(binned, gf, hf, live, local, *args)
        # the float bound of any float32 order, kept beside the bitwise
        # gates: a float32 sum of k terms in any order is within about
        # (k-1)*u*sum|x| of the exact sum (u = 2^-24), so two orders
        # differ by under 2(k-1)*u*sum|x|; 4*k*u*sum|x| per cell also
        # covers the rounding of sum|x| itself
        absum = H.level_histogram_reference(binned, gf.abs(), hf.abs(), live,
                                            local, *args)
        bound = 4.0 * p[..., 2:3] * F32_EPS * absum
        err = (k - p).abs()
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(k_int, p_int))
        bitwise_float = bool(torch.equal(k, p))
        repeat = bool(torch.equal(k, k2))
        within = bool((err[..., :2] <= bound[..., :2]).all())
        counts_exact = bool(torch.equal(k[..., 2], p[..., 2]))
        del k2

        idx = H.flat_index(binned, local, F, B)
        src = torch.stack([gf * live, hf * live, live], -1)[:, None, :] \
            .expand(N, F, 3).reshape(-1, 3)
        kernel_ms = time_ms(torch, lambda: H.level_histogram(
            binned, gf, hf, live, local, *args))
        kernel_device_ms = device_ms(torch, lambda: H.level_histogram(
            binned, gf, hf, live, local, *args))
        # one call's device time by kernel: the partition (count, scan,
        # scatter), the histogram, the dequantization, torch's fills
        _, split = device_ms_by_kernel(torch, lambda: H.level_histogram(
            binned, gf, hf, live, local, *args))
        plain_ms = time_ms(torch, lambda: H.level_histogram_reference(
            binned, gf, hf, live, local, *args))
        library_ms = time_ms(torch, lambda: torch.zeros(
            (width * F * B, 3), device=dev).index_add_(0, idx, src))
        del idx, src
        in_bytes = sum(t.numel() * t.element_size()
                       for t in (binned, gf, hf, live, local))
        out_bytes = width * F * B * 3 * 4
        ops = 3 * F * int(live.sum().item())
        bytes_ms = (in_bytes + out_bytes) / MEM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        row = {"width": width, "bitwise_int": bitwise,
               "bitwise_float": bitwise_float, "repeat_bitwise": repeat,
               "float_within_bound": within, "counts_exact": counts_exact,
               "max_abs_err": float(err.max().item()),
               "kernel_ms": kernel_ms, "kernel_device_ms": kernel_device_ms,
               "plain_ms": plain_ms,
               "library_ms": library_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": in_bytes + out_bytes, "ops": ops,
               "device_ms_by_kernel": split}
        emit({"phase": "kernel_vs_plain", **row})
        rows.append(row)
        if not (bitwise and bitwise_float and repeat and within
                and counts_exact):
            raise AssertionError(f"level_hist disagrees with its plain "
                                 f"version at width {width}: {row}")
    ctx["hist_rows"] = rows
    return {"widths": list(WIDTHS), "all_bitwise": True}


def make_data(n, seed=0):
    """The bench's HIGGS-shaped synthetic problem (bench.py)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, F)).astype(np.float32)
    logit = (x[:, 0] * 1.2 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
             + 0.3 * np.sin(x[:, 4] * 3))
    y = (logit + rng.normal(size=n) * 0.5 > 0).astype(np.float64)
    return x, y


def phase_main(ctx):
    import torch

    from mmlspark_tpu_torch import BinMapper, TrainConfig, train
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H

    x, y = make_data(N)
    t0 = time.perf_counter()
    mapper = BinMapper.fit(x[:100_000], max_bin=255)
    binned = mapper.transform(x)
    bin_upper = mapper.bin_upper_values(255)
    bin_s = time.perf_counter() - t0
    cfg = TrainConfig(objective="binary", num_iterations=TREES,
                      num_leaves=63, max_depth=6, min_data_in_leaf=20)

    def syncs_of(num_trees):
        """Host syncs in a fit of ``num_trees`` trees."""
        return count_syncs(torch, lambda: train(
            binned, y, dataclasses.replace(cfg, num_iterations=num_trees),
            bin_upper=bin_upper))

    # the boosting loop must not wait on the device: after a warm-up fit
    # (one-off start-up syncs), a 1-tree and a 3-tree fit make the same
    # syncs — set-up and the final transfer only
    syncs_of(1)
    syncs = {t: syncs_of(t) for t in (1, 3)}
    if syncs[1] != syncs[3]:
        raise AssertionError(f"host syncs grow with the tree count: {syncs}")
    torch.cuda.synchronize()

    H.hist_kernel_launches = H.hist_quant_kernel_launches = 0
    t0 = time.perf_counter()
    result = train(binned, y, cfg, bin_upper=bin_upper)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = H.hist_kernel_launches
    quant_launches = H.hist_quant_kernel_launches
    ctx["launches"] = {"level_hist": launches}
    ctx["main_inputs"] = (binned, y, bin_upper, cfg)
    # the fixed-point histogram makes the float32 fit reproducible
    reproducible = boosters_equal(
        result.booster, train(binned, y, cfg, bin_upper=bin_upper).booster)

    booster = result.booster
    lls = [e["train_binary_logloss"] for e in result.evals]
    binned_d = torch.as_tensor(binned.astype(np.uint8), device="cuda")
    booster.predict_binned(binned_d[:1000])          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = booster.predict_binned(binned_d)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    # the same booster on a small slice scored on the CPU: same per-tree
    # float32 ops in the same order, so bitwise equal
    small = binned[:100_000].astype(np.uint8)
    cpu_scores = booster.predict_binned(small, device="cpu")
    expected = TREES * cfg.effective_depth
    out = {"bin_s": bin_s, "fit_s": fit_s, "score_s": score_s,
           "trees": booster.num_trees, "launches": launches,
           "expected_launches": expected,
           "syncs_per_fit": syncs[3], "two_fits_bitwise": reproducible,
           "logloss_first": lls[0], "logloss_last": lls[-1],
           "fit_mrow_trees_per_s": N * booster.num_trees / fit_s / 1e6,
           "score_mrow_trees_per_s": N * booster.num_trees / score_s / 1e6,
           "card": ctx["smi"]}
    if launches != expected or quant_launches:
        raise AssertionError(f"level_hist launched {launches} times in the "
                             f"fit, expected {expected}; level_hist_quant "
                             f"{quant_launches}, expected 0")
    if not all(b <= a + 1e-7 for a, b in zip(lls, lls[1:])) \
            or not lls[-1] < lls[0]:
        raise AssertionError(f"training logloss does not fall: {lls}")
    if not reproducible:
        raise AssertionError("two float32 fits gave different boosters")
    if tuple(scores.shape) != (N,) or not bool(torch.isfinite(scores).all()):
        raise AssertionError("scores are not finite of shape (N,)")
    if not torch.equal(scores[:100_000].cpu(), cpu_scores):
        raise AssertionError("card and CPU scoring of one booster differ")
    return out


def phase_profile(ctx):
    """Where a bench-shape fit's device time goes: a 5-tree fit under
    torch.profiler (binned matrix already on the card), device time by
    kernel name and the device's idle share of the fit's wall time."""
    import torch

    from mmlspark_tpu_torch import train

    binned, y, bin_upper, cfg = ctx["main_inputs"]
    cfg = dataclasses.replace(cfg, num_iterations=5)
    binned_d = torch.as_tensor(binned.astype(np.uint8), device="cuda")
    wall_ms, by_name = device_ms_by_kernel(
        torch, lambda: train(binned_d, y, cfg, bin_upper=bin_upper))
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    hist_ms = hist_device_ms(by_name)
    return {"trees": 5, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if busy_ms else "not measured",
            "device_idle_share": 1 - busy_ms / wall_ms if busy_ms
            else "not measured",
            "level_hist_share_of_busy": hist_ms / busy_ms if busy_ms
            else "not measured",
            "kernel_names": len(by_name),
            "top_ms": dict(top)}


def phase_card_vs_cpu(ctx):
    from mmlspark_tpu_torch import BinMapper, TrainConfig, train

    x, y = make_data(100_000, seed=1)
    mapper = BinMapper.fit(x, max_bin=255)
    binned = mapper.transform(x)
    cfg = TrainConfig(objective="binary", num_iterations=5, num_leaves=63,
                      max_depth=6, min_data_in_leaf=20)
    res = {dev: train(binned, y, cfg, device=dev) for dev in ("cuda", "cpu")}
    a, b = res["cuda"].booster, res["cpu"].booster
    roots_equal = (np.array_equal(a.split_feature[:, 0], b.split_feature[:, 0])
                   and np.array_equal(a.threshold_bin[:, 0],
                                      b.threshold_bin[:, 0]))
    ll = {dev: r.evals[-1]["train_binary_logloss"] for dev, r in res.items()}
    # the histograms are the same bits on both devices (fixed point); the
    # objective and split finding reduce in another order on the card:
    # float32 rounding only, far below 1e-4 relative
    rel = abs(ll["cuda"] - ll["cpu"]) / abs(ll["cpu"])
    names = ("split_feature", "threshold_bin", "node_value", "count")
    trees_equal = int(sum(all(np.array_equal(getattr(a, k)[t],
                                             getattr(b, k)[t])
                              for k in names)
                          for t in range(a.num_trees)))
    out = {"roots_equal": roots_equal, "trees_equal_in_every_array":
           trees_equal, "trees": a.num_trees, "logloss_cuda": ll["cuda"],
           "logloss_cpu": ll["cpu"], "rel_diff": rel, "tol": 1e-4}
    if not roots_equal or rel > 1e-4:
        raise AssertionError(f"card and CPU fits disagree: {out}")
    return out


def phase_kernel_quant(ctx):
    """Quantized level-histogram kernel vs its plain version at the bench
    shape, q16 and q8, every level width: bitwise, and bitwise between
    two launches on the same inputs."""
    import torch

    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    binned = torch.randint(0, B, (N, F), generator=gen, device=dev,
                           dtype=torch.uint8)
    live = (torch.rand(N, generator=gen, device=dev) < 0.9).float()
    rows = {}
    for quant, (dtype_name, qmax) in QUANTS.items():
        dtype = getattr(torch, dtype_name)
        # the trainer's quantization of normal grads and uniform hess
        gq = torch.round(torch.randn(N, generator=gen, device=dev)
                         .clamp(-4, 4) * (qmax / 4)).to(dtype)
        hq = torch.round(torch.rand(N, generator=gen, device=dev)
                         * qmax).to(dtype)
        gsi = torch.full((), 2.0 ** -12, device=dev)
        hsi = torch.full((), 2.0 ** -14, device=dev)
        rows[quant] = []
        for width in WIDTHS:
            local = torch.randint(0, width, (N,), generator=gen, device=dev)
            args = (binned, gq, hq, live, local, width, F, B, gsi, hsi)
            k1 = H.level_histogram_quant(*args)
            k2 = H.level_histogram_quant(*args)
            p = H.level_histogram_quant_reference(*args)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(k1, p))
            repeat = bool(torch.equal(k1, k2))
            err = float((k1 - p).abs().max().item())

            idx = H.flat_index(binned, local, F, B)
            gate = (live > 0).long()
            src = torch.stack([gq.long() * gate, hq.long() * gate, gate],
                              -1)[:, None, :].expand(N, F, 3).reshape(-1, 3)
            kernel_ms = time_ms(torch, lambda: H.level_histogram_quant(*args))
            kernel_device_ms = device_ms(
                torch, lambda: H.level_histogram_quant(*args))
            # one call's device time by kernel: the partition (count, scan,
            # scatter), the histogram, the dequantization, torch's fills
            _, split = device_ms_by_kernel(
                torch, lambda: H.level_histogram_quant(*args))
            plain_ms = time_ms(torch, lambda: H.level_histogram_quant_reference(
                *args))
            library_ms = time_ms(torch, lambda: torch.zeros(
                (width * F * B, 3), dtype=torch.int64,
                device=dev).index_add_(0, idx, src))
            del idx, src
            in_bytes = sum(t.numel() * t.element_size()
                           for t in (binned, gq, hq, live, local))
            out_bytes = width * F * B * 3 * 4
            ops = 3 * F * int(gate.sum().item())
            bytes_ms = (in_bytes + out_bytes) / MEM_BYTES_PER_S * 1e3
            ops_ms = ops / F32_OPS_PER_S * 1e3
            row = {"quant": quant, "width": width, "bitwise": bitwise,
                   "repeat_bitwise": repeat, "max_abs_err": err,
                   "kernel_ms": kernel_ms,
                   "kernel_device_ms": kernel_device_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations",
                   "bytes": in_bytes + out_bytes, "ops": ops,
                   "device_ms_by_kernel": split}
            emit({"phase": "kernel_quant_vs_plain", **row})
            rows[quant].append(row)
            if not (bitwise and repeat):
                raise AssertionError(f"level_hist_quant[{quant}] disagrees "
                                     f"at width {width}: {row}")
    ctx["quant_rows"] = rows
    return {"quants": list(QUANTS), "widths": list(WIDTHS),
            "all_bitwise": True, "window": quant_window_case(torch, H),
            "sass_atomics": quant_sass_atomics()}


def quant_window_case(torch, H):
    """q16 at 40,000,000 rows, F=4, every row +32000 in bin 0: a CTA's run
    in one node passes the W = 65,535 rows an int32 cell holds at
    2^15 per row, so the kernel must flush mid-node; a missed flush wraps.
    Bitwise against the plain version and between two launches, widths 1
    and 2."""
    n, f = 40_000_000, 4
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    binned = torch.zeros((n, f), dtype=torch.uint8, device=dev)
    stat = torch.full((n,), 32000, dtype=torch.int16, device=dev)
    live = torch.ones(n, device=dev)
    gsi = torch.full((), 2.0 ** -12, device=dev)
    out = {"rows": n, "features": f, "window_rows": H.quant_window(16)}
    for width in (1, 2):
        local = torch.randint(0, width, (n,), generator=gen, device=dev)
        args = (binned, stat, stat, live, local, width, f, B, gsi, gsi)
        k1 = H.level_histogram_quant(*args)
        k2 = H.level_histogram_quant(*args)
        p = H.level_histogram_quant_reference(*args)
        torch.cuda.synchronize()
        row = {"bitwise": bool(torch.equal(k1, p)),
               "repeat_bitwise": bool(torch.equal(k1, k2)),
               "grad_sum_bin0": float(k1[0, 0, 0, 0].item()),
               "plain_grad_sum_bin0": float(p[0, 0, 0, 0].item())}
        out[f"width_{width}"] = row
        del p, k1, k2, local
        if not (row["bitwise"] and row["repeat_bitwise"]):
            raise AssertionError(f"level_hist_quant wraps past the int32 "
                                 f"window at width {width}: {row}")
    return out


def quant_sass_atomics():
    """The atomic opcodes in the SASS of the built ``level_hist_quant``
    library (``cuobjdump -sass``): its int32 cells must take native shared
    adds (``ATOMS.ADD``), never a CAS loop (``ATOMS.CAST.SPIN``)."""
    from mmlspark_tpu_torch.native import bindings
    cuobjdump = os.path.join(os.path.dirname(bindings.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", str(bindings.library_path("level_hist_quant"))],
        capture_output=True, text=True, timeout=120, check=True).stdout
    atomics = {}
    for op in re.findall(r"\b((?:ATOMS|ATOM|RED)\.[A-Z0-9.]+)", sass):
        atomics[op] = atomics.get(op, 0) + 1
    if "ATOMS.ADD" not in atomics or any("CAS" in op for op in atomics):
        raise AssertionError(f"level_hist_quant's shared adds are not "
                             f"native: {atomics}")
    return atomics


def phase_main_quant(ctx):
    """The bench fit on the quantized plane, and both planes with
    histogram subtraction."""
    import torch

    from mmlspark_tpu_torch import train
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H

    binned, y, bin_upper, cfg = ctx["main_inputs"]
    expected = TREES * cfg.effective_depth
    out = {"card": ctx["smi"]}

    def fit(quant, sub, trees=TREES):
        """One timed fit; the kernels' launches counted from 0."""
        with knobs(quant, sub):
            H.hist_kernel_launches = H.hist_quant_kernel_launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = train(binned, y,
                        dataclasses.replace(cfg, num_iterations=trees),
                        bin_upper=bin_upper)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        lls = [e["train_binary_logloss"] for e in res.evals]
        if not all(b <= a + 1e-7 for a, b in zip(lls, lls[1:])) \
                or not lls[-1] < lls[0]:
            raise AssertionError(f"{quant}/sub={sub}: training logloss does "
                                 f"not fall: {lls}")
        want = {"hist_quant": quant, "subtract": sub == "1"}
        if res.hist_stats != want:
            raise AssertionError(f"ran {res.hist_stats}, asked for {want}")
        return res, fit_s, (H.hist_kernel_launches,
                            H.hist_quant_kernel_launches), lls

    ctx["launches"]["level_hist_quant"] = {}
    sub_off = {}
    for quant in QUANTS:
        with knobs(quant, "0"):
            train(binned, y, dataclasses.replace(cfg, num_iterations=1),
                  bin_upper=bin_upper)                     # warm-up
            syncs = {t: count_syncs(torch, lambda t=t: train(
                binned, y, dataclasses.replace(cfg, num_iterations=t),
                bin_upper=bin_upper)) for t in (1, 3)}
        if syncs[1] != syncs[3]:
            raise AssertionError(f"{quant}: host syncs grow with the tree "
                                 f"count: {syncs}")
        first, fit_s, (f32_n, quant_n), lls = fit(quant, "0")
        second, _, _, _ = fit(quant, "0")
        if (f32_n, quant_n) != (0, expected):
            raise AssertionError(f"{quant} fit launched level_hist {f32_n} "
                                 f"and level_hist_quant {quant_n} times, "
                                 f"expected 0 and {expected}")
        reproducible = boosters_equal(first.booster, second.booster)
        if not reproducible:
            raise AssertionError(f"two {quant} fits gave different boosters")
        ctx["launches"]["level_hist_quant"][quant] = quant_n
        sub_off[quant] = first.booster
        out[quant] = {"fit_s": fit_s, "launches": quant_n,
                      "f32_launches": f32_n, "syncs_per_fit": syncs[3],
                      "two_fits_bitwise": reproducible,
                      "logloss_first": lls[0], "logloss_last": lls[-1],
                      "fit_mrow_trees_per_s": N * TREES / fit_s / 1e6}

    # subtraction on, both planes: fit rate, and the kernels' device
    # time per tree (5-tree profiled fits) with subtraction off and on
    for quant in ("off", "q16"):
        res, fit_s, counts, lls = fit(quant, "1")
        launched = counts[1] if quant == "q16" else counts[0]
        if launched != expected:
            raise AssertionError(f"{quant}/sub=1 launched {counts}")
        row = {"fit_s": fit_s, "launches": launched,
               "logloss_last": lls[-1],
               "fit_mrow_trees_per_s": N * TREES / fit_s / 1e6}
        if quant == "q16":
            # the derived sibling is parent - smaller in float32, so node
            # values may move in the last bits where bin sums round
            row["arrays_differing_from_sub_off"] = arrays_differing(
                res.booster, sub_off["q16"])
            row["trees_equal_to_sub_off"] = \
                not row["arrays_differing_from_sub_off"]
        binned_d = torch.as_tensor(binned.astype(np.uint8), device="cuda")
        for sub in ("0", "1"):
            with knobs(quant, sub):
                wall_ms, by_name = device_ms_by_kernel(torch, lambda: train(
                    binned_d, y, dataclasses.replace(cfg, num_iterations=5),
                    bin_upper=bin_upper))
            hist_ms = hist_device_ms(by_name)
            row[f"hist_ms_per_tree_sub{sub}"] = hist_ms / 5
            row[f"profiled_wall_ms_per_tree_sub{sub}"] = wall_ms / 5
        out[f"sub_{quant}"] = row
    return out


def phase_card_vs_cpu_quant(ctx):
    from mmlspark_tpu_torch import BinMapper, TrainConfig, train

    x, y = make_data(100_000, seed=1)
    mapper = BinMapper.fit(x, max_bin=255)
    binned = mapper.transform(x)
    cfg = TrainConfig(objective="binary", num_iterations=5, num_leaves=63,
                      max_depth=6, min_data_in_leaf=20)
    with knobs("q16", "0"):
        res = {dev: train(binned, y, cfg, device=dev)
               for dev in ("cuda", "cpu")}
    a, b = res["cuda"].booster, res["cpu"].booster
    roots_equal = (np.array_equal(a.split_feature[:, 0], b.split_feature[:, 0])
                   and np.array_equal(a.threshold_bin[:, 0],
                                      b.threshold_bin[:, 0]))
    names = ("split_feature", "threshold_bin", "node_value", "count")
    trees_equal = int(sum(all(np.array_equal(getattr(a, k)[t],
                                             getattr(b, k)[t])
                              for k in names)
                          for t in range(a.num_trees)))
    ll = {dev: r.evals[-1]["train_binary_logloss"] for dev, r in res.items()}
    rel = abs(ll["cuda"] - ll["cpu"]) / abs(ll["cpu"])
    out = {"roots_equal": roots_equal, "trees_equal_in_every_array":
           trees_equal, "trees": a.num_trees, "logloss_cuda": ll["cuda"],
           "logloss_cpu": ll["cpu"], "rel_diff": rel, "tol": 1e-4,
           "note": "histograms are exact integers on both devices; the "
                   "objective, the scales' log and split finding may differ "
                   "by an ulp between devices, so full equality is not "
                   "required"}
    if not roots_equal or rel > 1e-4:
        raise AssertionError(f"card and CPU q16 fits disagree: {out}")
    return out


def flash_bound(b, n, nk, h, d, causal, dtype):
    """The least time for the flash function: q, k, v read once and the
    output written once, over the memory rate; 4*d operations per
    unmasked (query, key) pair, over the peak rate for the input type:
    float32 outside the tensor cores (the function is specified in full
    float32, as the TPU kernel computes it), bfloat16 on the tensor
    cores. The TF32 tensor-core time is a note only."""
    if causal:   # top-left aligned: query i sees min(i + 1, nk) keys
        m = min(n, nk)
        pairs = m * (m + 1) // 2 + (n - m) * nk
    else:
        pairs = n * nk
    ops = 4 * b * h * d * pairs
    nbytes = (2 * n + 2 * nk) * b * h * d * dtype.itemsize
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    rate = BF16_OPS_PER_S if str(dtype) == "torch.bfloat16" \
        else F32_OPS_PER_S
    ops_ms = ops / rate * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "tf32_ops_ms": ops / TF32_OPS_PER_S * 1e3}


def bf16_step_misses(torch, a, b, atol, rtol=0.0):
    """How many elements of two bfloat16 results do not agree as two
    float32 results within ``atol + rtol*|b|``, each then rounded once to
    bfloat16: that plus one bf16 step (2^-8 of the larger magnitude's power
    of two)."""
    a, b = a.float(), b.float()
    _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
    step = torch.ldexp(torch.ones_like(a), exp - 8)
    return int(((a - b).abs() > step + atol + rtol * b.abs()).sum())


def within_bf16_step(torch, a, b, atol, rtol=0.0):
    return bf16_step_misses(torch, a, b, atol, rtol) == 0


def exact_attention(torch, q, k, v, causal):
    """The function in float64 from the same (rounded) inputs, dense: the
    value both float32 computations approximate."""
    q, k, v = (x.double().transpose(1, 2) for x in (q, k, v))
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    if causal:
        n, nk = s.shape[-2:]
        keep = torch.arange(nk, device=s.device)[None, :] \
            <= torch.arange(n, device=s.device)[:, None]
        s = s.masked_fill(~keep, float("-inf"))
    return (torch.softmax(s, dim=-1) @ v).transpose(1, 2)


def attention_inputs(torch, shape, dtype, seed, nk=None, scale=1.0,
                     layout="contiguous"):
    """Seeded normal q, k, v (q and k times ``scale``) in one of the
    layouts a caller may pass: ``contiguous`` (b, n, h, d) tensors;
    ``packed`` views into one (b, n, 3, h, d) tensor; ``bhnd`` (b, h, n,
    d) tensors seen as (b, n, h, d); ``misaligned`` tensors whose base is
    one element past an allocation (2 bytes for bf16: off TMA's 16)."""
    b, n, h, d = shape
    nk = n if nk is None else nk
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def mk(length, s):
        x = torch.randn((b, length, h, d), generator=gen, device="cuda") * s
        if layout == "bhnd":
            return x.transpose(1, 2).contiguous().to(dtype).transpose(1, 2)
        if layout == "misaligned":
            flat = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
            view = flat[1:].view(x.shape)
            view.copy_(x)
            return view
        return x.to(dtype)
    if layout == "packed":
        if nk != n:
            raise ValueError("a packed qkv tensor has one length")
        qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda")
        qkv[:, :, :2] *= scale
        qkv = qkv.to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return mk(n, scale), mk(nk, scale), mk(nk, 1.0)


def host_us_per_call(torch, fn, calls=200):
    """Host microseconds per call over ``calls`` calls with no synchronise
    between them: what the wrapper costs the host, which sets the pace of
    back-to-back calls when it exceeds the kernel's time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def phase_kernel_flash(ctx):
    """Both flash kernels vs their plain version: every case within the
    stated tolerance, two launches bitwise equal and of the kernel the
    case expects, times beside the bound."""
    import torch
    import torch.nn.functional as TF

    from mmlspark_tpu_torch.parallel import flash as FL
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 matmuls are on: the plain version must "
                             "run in full float32")
    f32, bf16 = torch.float32, torch.bfloat16
    b, n, h, d = FLASH_AB
    sm90, staged, simt = FL.SM90, FL.SM90_STAGED, FL.SIMT
    cases = [  # name, shape, nk, dtype, causal, score scale, layout, route
        ("ab_f32_causal", FLASH_AB, None, f32, True, 1.0, "contiguous", simt),
        ("ab_f32", FLASH_AB, None, f32, False, 1.0, "contiguous", simt),
        ("ab_bf16_causal", FLASH_AB, None, bf16, True, 1.0, "contiguous",
         sm90),
        ("ab_bf16", FLASH_AB, None, bf16, False, 1.0, "contiguous", sm90),
        ("ab_bf16_causal_misaligned", FLASH_AB, None, bf16, True, 1.0,
         "misaligned", staged),
        ("d16_causal", (b, n, h, 16), None, f32, True, 1.0, "contiguous",
         simt),
        ("d16_bf16_causal", (b, n, h, 16), None, bf16, True, 1.0,
         "contiguous", sm90),
        ("d128_causal", (b, n, h, 128), None, f32, True, 1.0, "contiguous",
         simt),
        ("d128_bf16_causal", (b, n, h, 128), None, bf16, True, 1.0,
         "contiguous", sm90),
        ("cross_512x2048", (b, 512, h, d), 2048, f32, False, 1.0,
         "contiguous", simt),
        ("cross_512x2048_causal", (b, 512, h, d), 2048, f32, True, 1.0,
         "contiguous", simt),
        ("cross_512x2048_bf16", (b, 512, h, d), 2048, bf16, False, 1.0,
         "contiguous", sm90),
        ("cross_512x2048_bf16_causal", (b, 512, h, d), 2048, bf16, True,
         1.0, "contiguous", sm90),
        ("ragged_1000x1500_bf16_causal", (b, 1000, h, d), 1500, bf16, True,
         1.0, "contiguous", sm90),
        ("ragged_1500x1000_bf16_d128", (b, 1500, h, 128), 1000, bf16, False,
         1.0, "contiguous", sm90),
        ("large_scores_x30", FLASH_AB, None, f32, False, 30.0, "contiguous",
         simt),
        ("packed_qkv_bf16_causal", FLASH_AB, None, bf16, True, 1.0, "packed",
         sm90),
        ("bhnd_view_bf16_causal", FLASH_AB, None, bf16, True, 1.0, "bhnd",
         sm90),
        ("large_scores_x30_bf16", FLASH_AB, None, bf16, False, 30.0,
         "contiguous", sm90),
        # appended, so the cases above keep their seeds
        ("d32_bf16_causal", (b, n, h, 32), None, bf16, True, 1.0,
         "contiguous", sm90),
        ("d36_bf16_causal", (b, n, h, 36), None, bf16, True, 1.0,
         "contiguous", staged),
        ("d33_bf16_causal", (b, n, h, 33), None, bf16, True, 1.0,
         "contiguous", staged),
        ("d96_bf16_causal", (b, n, h, 96), None, bf16, True, 1.0,
         "contiguous", sm90),
        ("ragged_1000x1500_causal", (b, 1000, h, d), 1500, f32, True, 1.0,
         "contiguous", simt),
        ("d33_causal", (b, n, h, 33), None, f32, True, 1.0, "contiguous",
         simt),
        ("d96_causal", (b, n, h, 96), None, f32, True, 1.0, "contiguous",
         simt),
    ]
    rows = {}
    for seed, (name, shape, nk, dtype, causal, scale, layout,
               kernel) in enumerate(cases):
        q, k, v = attention_inputs(torch, shape, dtype, 10 + seed, nk, scale,
                                   layout)
        # ragged lengths: one block each, so flash_attention's block check
        # passes (the kernels tile by themselves)
        blocks = {} if shape[1] % 128 == 0 and k.shape[1] % 128 == 0 \
            else {"block_q": shape[1], "block_k": k.shape[1]}

        def call():
            return FL.flash_attention(q, k, v, causal=causal, **blocks)
        total0, sm90_0, staged0 = (FL.flash_kernel_launches,
                                   FL.flash_sm90_launches,
                                   FL.flash_staged_calls)
        k1, k2 = call(), call()
        torch.cuda.synchronize()
        sm90_n = FL.flash_sm90_launches - sm90_0
        staged_n = FL.flash_staged_calls - staged0
        launched = {sm90: sm90_n - staged_n, staged: staged_n,
                    simt: FL.flash_kernel_launches - total0 - sm90_n}
        p = FL.flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (k1.float() - p.float()).abs()
        extra = {}
        if dtype == f32:
            within = bool((err <= 2e-5 + 2e-4 * p.abs()).all())
            tol = "rtol 2e-4, atol 2e-5"
        elif scale == 1.0:
            within = within_bf16_step(torch, k1, p, 2e-5, 2e-4)
            tol = "rtol 2e-4, atol 2e-5, plus one bf16 step"
        else:
            # scores x30 (|s| ~ 1e3): the plain version and the kernel sum
            # q.k in other orders, and near ties then move an output by
            # more than the gate, for the plain version as well: both are
            # held to the float64 value, and the kernel may miss the gate
            # against it at no more outputs than the plain version does
            exact = exact_attention(torch, q, k, v, causal)
            misses = bf16_step_misses(torch, k1, exact, 2e-5, 2e-4)
            plain_misses = bf16_step_misses(torch, p, exact, 2e-5, 2e-4)
            within = misses <= plain_misses
            tol = ("rtol 2e-4, atol 2e-5, plus one bf16 step, against the "
                   "float64 value: misses at no more outputs than the "
                   "plain version")
            extra = {
                "gate_misses_vs_float64": misses,
                "plain_gate_misses_vs_float64": plain_misses,
                "gate_misses_vs_plain": bf16_step_misses(
                    torch, k1, p, 2e-5, 2e-4),
                "outputs": k1.numel(),
                "max_abs_err_vs_float64": float(
                    (k1.double() - exact).abs().max()),
                "plain_max_abs_err_vs_float64": float(
                    (p.double() - exact).abs().max())}
            del exact
        repeat = bool(torch.equal(k1, k2))
        finite = bool(torch.isfinite(k1).all())
        routed = launched == {r: 2 if r == kernel else 0 for r in launched}
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def sdpa():
            return TF.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal)
        row = {"case": name, "shape": list(shape),
               "nk": k.shape[1], "dtype": str(dtype).split(".")[-1],
               "causal": causal, "layout": layout, "kernel": kernel,
               "launched": launched, "routed": routed, "within": within,
               "tol": tol, **extra, "repeat_bitwise": repeat,
               "finite": finite,
               "max_abs_err": float(err.max().item()),
               "call_ms": time_ms(torch, call),
               "plain_ms": time_ms(torch, lambda: FL.flash_attention_reference(
                   q, k, v, causal=causal), reps=5, warmup=1),
               "library_ms": device_ms(torch, sdpa),
               "library_call_ms": time_ms(torch, sdpa),
               **flash_bound(shape[0], shape[1], k.shape[1], shape[2],
                             shape[3], causal, q.dtype)}
        # device time of the call, and for a staged route that of its
        # staging copies alone
        row["kernel_ms"] = device_ms(torch, call)
        if kernel == staged:
            row["staging_ms"] = device_ms(torch, lambda: [
                FL.stage_for_tma(t) for t in (q, k, v)])
            row["flash_kernel_ms"] = row["kernel_ms"] - row["staging_ms"]
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        row["vs_library"] = row["kernel_ms"] / row["library_ms"]
        if name.startswith("ab_"):
            row["host_us_per_call"] = host_us_per_call(torch, call)
        del qt, kt, vt
        emit({"phase": "kernel_flash_vs_plain", **row})
        rows[name] = row
        if not (within and repeat and finite and routed):
            raise AssertionError(f"flash case {name} failed: {row}")
    ctx["flash_rows"] = rows
    return {"cases": list(rows), "all_agree": True, "card": ctx["smi"]}


def phase_sdpa_backends(ctx):
    """The yardstick: ``scaled_dot_product_attention`` at the A/B shape
    (causal) in float32 and bfloat16 under each backend alone. Which
    backends take the call, their device and call times and their max abs
    error against the plain version (float32 in full: TF32 would show as
    an error of about 1e-3), and which backend the default call matches
    bit for bit."""
    import torch
    import torch.nn.functional as TF
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from mmlspark_tpu_torch.parallel import flash as FL
    out = {"card": ctx["smi"]}
    for seed, dtype in enumerate((torch.float32, torch.bfloat16)):
        q, k, v = attention_inputs(torch, FLASH_AB, dtype, 60 + seed)
        ref = FL.flash_attention_reference(q, k, v, causal=True).float()
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def sdpa():
            return TF.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True)
        default = sdpa()
        rows = {"default": {
            "ms": device_ms(torch, sdpa), "call_ms": time_ms(torch, sdpa),
            "max_abs_err": float(
                (default.transpose(1, 2).float() - ref).abs().max())}}
        for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                     "CUDNN_ATTENTION", "MATH"):
            backend = getattr(SDPBackend, name, None)
            if backend is None:
                rows[name] = {"accepted": False,
                              "reason": "not in this PyTorch"}
                continue

            def forced(backend=backend):
                with sdpa_kernel([backend]):
                    return sdpa()
            try:
                got = forced()
                torch.cuda.synchronize()
            except RuntimeError as e:
                rows[name] = {"accepted": False, "reason": str(e)[:300]}
                continue
            rows[name] = {
                "accepted": True, "ms": device_ms(torch, forced),
                "call_ms": time_ms(torch, forced),
                "max_abs_err": float(
                    (got.transpose(1, 2).float() - ref).abs().max()),
                "equals_default": bool(torch.equal(got, default))}
        rows["default_is"] = [n for n, r in rows.items()
                              if isinstance(r, dict)
                              and r.get("equals_default")]
        out[str(dtype).split(".")[-1]] = rows
    return out


def phase_attention_path(ctx):
    """``fused_attention`` through the kernels at the A/B shape (float32
    and bfloat16, and bfloat16 at d=32 and through a misaligned view, the
    second on copies staged for TMA) and at n=16384, counted by route,
    against the blockwise loop. No bfloat16 call may launch
    ``flash_attn.cu``."""
    import torch

    from mmlspark_tpu_torch.parallel import attention as AT
    from mmlspark_tpu_torch.parallel import flash as FL
    f32, bf16 = torch.float32, torch.bfloat16
    b, n, h, _ = FLASH_AB
    # name, shape, dtype, layout, reps, route, kernel-table key
    runs = [
        ("ab_f32", FLASH_AB, f32, "contiguous", 20, FL.SIMT,
         "flash_attn[f32]"),
        ("ab_bf16", FLASH_AB, bf16, "contiguous", 20, FL.SM90,
         "flash_attn_sm90[bf16]"),
        ("ab_bf16_d32", (b, n, h, 32), bf16, "contiguous", 20, FL.SM90,
         "flash_attn_sm90[bf16]"),
        ("long_f32", FLASH_LONG, f32, "contiguous", 3, FL.SIMT,
         "flash_attn[f32]"),
        ("long_bf16", FLASH_LONG, bf16, "contiguous", 3, FL.SM90,
         "flash_attn_sm90[bf16]"),
        # appended, so the runs above keep their seeds
        ("ab_bf16_misaligned", FLASH_AB, bf16, "misaligned", 20,
         FL.SM90_STAGED, "flash_attn_sm90[bf16,staged]")]
    out = {"card": ctx["smi"]}
    launches = {"flash_attn[f32]": 0, "flash_attn_sm90[bf16]": 0,
                "flash_attn_sm90[bf16,staged]": 0, "flash_attn[bf16]": 0}
    for seed, (name, shape, dtype, layout, reps, route,
               kernel) in enumerate(runs):
        q, k, v = attention_inputs(torch, shape, dtype, 30 + seed,
                                   layout=layout)
        FL.flash_kernel_launches = FL.flash_sm90_launches = 0
        FL.flash_staged_calls = 0
        fused = AT.fused_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        sm90, staged = FL.flash_sm90_launches, FL.flash_staged_calls
        counts = {FL.SIMT: FL.flash_kernel_launches - sm90,
                  FL.SM90: sm90 - staged, FL.SM90_STAGED: staged}
        if dtype == f32:
            launches["flash_attn[f32]"] += counts[FL.SIMT]
        else:
            launches["flash_attn[bf16]"] += counts[FL.SIMT]
            launches["flash_attn_sm90[bf16]"] += counts[FL.SM90]
            launches["flash_attn_sm90[bf16,staged]"] += counts[FL.SM90_STAGED]
        ref = AT.blockwise_attention(q.float(), k.float(), v.float(),
                                     causal=True)
        if dtype == f32:
            agree = bool(torch.allclose(fused, ref, rtol=0, atol=1e-4))
        else:
            agree = within_bf16_step(torch, fused, ref.to(dtype), 1e-4)
        bs, ns, hs, ds = shape
        fused_ms = time_ms(torch, lambda: AT.fused_attention(
            q, k, v, causal=True), reps=reps)
        blockwise_ms = time_ms(torch, lambda: AT.blockwise_attention(
            q, k, v, causal=True), reps=reps, warmup=1)
        useful = 2 * bs * hs * ns * ns * ds   # the A/B script's causal count
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
               "layout": layout, "route": route, "kernel": kernel,
               "launches": counts,
               "agrees_with_blockwise": agree,
               "max_abs_diff": float((fused.float() - ref).abs().max()),
               "fused_ms": fused_ms, "blockwise_ms": blockwise_ms,
               "fused_causal_tflops": useful / fused_ms / 1e9,
               "blockwise_causal_tflops": useful / blockwise_ms / 1e9}
        if name == "ab_bf16":
            # ten back-to-back calls under the profiler: the device's
            # share of the wall, by kernel, and the host's time by op
            def ten():
                for _ in range(10):
                    AT.fused_attention(q, k, v, causal=True)
            wall, device, host = profile_ms(torch, ten)
            busy = sum(device.values())
            row.update(profiled_wall_ms_10_calls=wall, device_busy_ms=busy,
                       device_idle_share=1 - busy / wall,
                       device_ms_by_kernel=top(device, 4),
                       host_self_ms_by_op=top(host, 8))
        out[name] = row
        if counts[route] != 1 or sum(counts.values()) != 1 or not agree:
            raise AssertionError(f"fused_attention {name}: {row}")
    if launches["flash_attn[bf16]"]:
        raise AssertionError(f"a bfloat16 call launched flash_attn.cu: "
                             f"{launches}")
    q, k, v = attention_inputs(torch, FLASH_AB, torch.float32, 40)
    try:
        AT.fused_attention(q.requires_grad_(), k, v, causal=True)
        raise AssertionError("the kernel path took an input requiring grad")
    except RuntimeError as e:
        out["requires_grad_refused"] = str(e)
    ctx["launches"]["flash_attn"] = launches
    return out


def phase_attention_dist(ctx):
    """Ring and Ulysses on a one-rank NCCL group; Ulysses launches the
    kernel through ``fused_attention``. Each call is also profiled
    (device time by kernel, host self time by op, the device's idle
    share) and timed without the shard-length check, to split its cost
    over the single-device call. Several ranks are held by the gloo
    tests on the CPU."""
    import shutil
    import tempfile
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from mmlspark_tpu_torch.parallel import attention as AT
    from mmlspark_tpu_torch.parallel import flash as FL
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=120))
    try:
        q, k, v = attention_inputs(torch, FLASH_AB, torch.float32, 50)
        ref = AT.blockwise_attention(q, k, v, causal=True)
        out = {"backend": dist.get_backend(), "world_size": 1,
               "card": ctx["smi"]}
        for name, fn in (("ring", AT.ring_attention),
                         ("ulysses", AT.ulysses_attention)):
            FL.flash_kernel_launches = 0
            got = fn(q, k, v, causal=True)
            torch.cuda.synchronize()
            count = FL.flash_kernel_launches
            agree = bool(torch.allclose(got, ref, rtol=0, atol=1e-4))

            def call():
                return fn(q, k, v, causal=True)
            row = {"launches": count, "agrees_with_blockwise": agree,
                   "max_abs_diff": float((got - ref).abs().max()),
                   "ms": time_ms(torch, call, reps=5, warmup=1)}
            length_check = AT._sequence_length
            AT._sequence_length = lambda chunk, group, size, dev: \
                chunk * size
            try:
                row["ms_without_shard_check"] = time_ms(torch, call, reps=5,
                                                        warmup=1)
            finally:
                AT._sequence_length = length_check
            wall, device, host = profile_ms(torch, call)
            busy = sum(device.values())
            row.update(profiled_wall_ms=wall, device_busy_ms=busy,
                       device_idle_share=1 - busy / wall,
                       device_ms_by_kernel=top(device, 8),
                       host_self_ms_by_op=top(host, 10))
            out[name] = row
            if not agree:
                raise AssertionError(f"{name}_attention disagrees: {out}")
        if out["backend"] != "nccl" or out["ulysses"]["launches"] != 1:
            raise AssertionError(f"Ulysses did not launch the kernel once "
                                 f"over NCCL: {out}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return out


def kernel_table(ctx):
    def entry(name, source, replaces, launches, rows):
        # times summed over the six level widths of one depth-6 tree
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["kernel_ms"] for r in rows),
            "device_ms": sum(r["kernel_device_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "library_ms": sum(r["library_ms"] for r in rows),
            "per": "sum over widths " + ",".join(map(str, WIDTHS))
                   + "; ms: an event pair per call (host included where it"
                   " outlasts the device), device_ms: calls queued behind"
                   " a spin kernel",
        }

    kernels = [entry("level_hist", "mmlspark_tpu_torch/csrc/level_hist.cu",
                     "mmlspark_tpu/models/gbdt/hist_pallas.py:60",
                     ctx["launches"]["level_hist"], ctx["hist_rows"])]
    for quant in QUANTS:
        kernels.append(entry(
            f"level_hist_quant[{quant}]",
            "mmlspark_tpu_torch/csrc/level_hist_quant.cu",
            "mmlspark_tpu/models/gbdt/hist_pallas.py:204",
            ctx["launches"]["level_hist_quant"][quant],
            ctx["quant_rows"][quant]))
    flash = ctx["flash_rows"]
    # flash_attn.cu takes float32 only: every bfloat16 call runs
    # flash_attn_sm90.cu, in place or staged
    for name, case, source in (
            ("flash_attn[f32]", "ab_f32_causal", "flash_attn.cu"),
            ("flash_attn_sm90[bf16]", "ab_bf16_causal",
             "flash_attn_sm90.cu"),
            ("flash_attn_sm90[bf16,staged]", "ab_bf16_causal_misaligned",
             "flash_attn_sm90.cu")):
        row = flash[case]
        extra = ({"staging_ms": row["staging_ms"]} if "staging_ms" in row
                 else {})
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mmlspark_tpu_torch/csrc/{source}",
            "replaces": "mmlspark_tpu/parallel/flash.py:24",
            "launches": ctx["launches"]["flash_attn"][name],
            "max_abs_err": max(r["max_abs_err"] for r in flash.values()
                               if r["dtype"] == row["dtype"]
                               and r["kernel"] == row["kernel"]),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], **extra,
            "per": f"one call at b=4, n=2048, h=8, d=64, causal ({case}); "
                   f"launches from phase attention_path",
        })
    return {"kernels": kernels}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import mmlspark_tpu_torch  # noqa: F401  (fails outside the repo)

    ctx = {}
    failed = []
    for name, fn in (("device", phase_device), ("kernel", phase_kernel),
                     ("main_path", phase_main), ("profile", phase_profile),
                     ("card_vs_cpu", phase_card_vs_cpu),
                     ("kernel_quant", phase_kernel_quant),
                     ("main_path_quant", phase_main_quant),
                     ("card_vs_cpu_quant", phase_card_vs_cpu_quant),
                     ("kernel_flash", phase_kernel_flash),
                     ("sdpa_backends", phase_sdpa_backends),
                     ("attention_path", phase_attention_path),
                     ("attention_dist", phase_attention_dist)):
        t0 = time.perf_counter()
        try:
            out = fn(ctx)
            emit({"phase": name, "ok": True,
                  "seconds": time.perf_counter() - t0, **out})
        except Exception as e:  # report every phase, then fail
            traceback.print_exc()
            emit({"phase": name, "ok": False, "error": repr(e)})
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    emit(kernel_table(ctx))
    print(ctx["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": ctx["kind"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
