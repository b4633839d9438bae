#!/usr/bin/env python3
"""The PyTorch port's main path on one CUDA card, end to end.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``mmlspark_tpu_torch/csrc`` (nvcc,
sm_90a), then:

  1. device: the card's name and power limit, torch/CUDA versions,
     kernel build time and the ptxas report;
  2. kernel vs plain: the level-histogram kernel against its plain
     PyTorch version at the HIGGS bench shape (N=2,000,000, F=28,
     B=255) for every level width of a depth-6 tree — bitwise on
     integer-valued stats, within a stated float bound otherwise — with
     CUDA-event timings of the kernel, the plain version and one
     ``index_add_`` call, and the bound from bytes and operations;
  3. main path: ``BinMapper.fit`` / ``transform``, ``train`` (binary,
     num_leaves=63, max_depth=6, 20 trees) and ``predict_binned`` on the
     2M rows, with the kernel's launch count over the fit, the training
     logloss per tree, and fit / scoring rates;
  4. profile: a 5-tree bench-shape fit under torch.profiler — device
     time by kernel and the device's idle share;
  5. card vs CPU: the same fit at 100k rows and 5 trees on ``cuda`` and
     on ``cpu`` through the port.

Each phase prints one JSON line. Any failure exits non-zero and prints
no result. Without a CUDA card it exits 2 at once. The last lines are
the kernel table, the ``nvidia-smi`` name/power line, and
``{"ok": true, "device": {...}}``.
"""

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
# float32 outside the tensor cores (the histogram's adds)
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32_EPS = 2.0 ** -24


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


def phase_device(ctx):
    import torch

    from mmlspark_tpu_torch.native import bindings
    t0 = time.perf_counter()
    reports = bindings.build()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in reports.items()}
    ctx["kind"] = torch.cuda.get_device_name(0)
    ctx["smi"] = nvidia_smi_line()
    return {"nvidia_smi": ctx["smi"], "torch": torch.__version__,
            "cuda": torch.version.cuda, "kind": ctx["kind"],
            "count": torch.cuda.device_count(),
            "kernel_build_s": build_s, "ptxas": ptxas}


def phase_kernel(ctx):
    """Level-histogram kernel vs its plain version at the bench shape."""
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
        p = H.level_histogram_reference(binned, gf, hf, live, local, *args)
        # float tolerance: a float32 sum of k terms in any order is within
        # about (k-1)*u*sum|x| of the exact sum (u = 2^-24), so two orders
        # differ by under 2(k-1)*u*sum|x|; 4*k*u*sum|x| per cell also
        # covers the rounding of sum|x| itself
        absum = H.level_histogram_reference(binned, gf.abs(), hf.abs(), live,
                                            local, *args)
        bound = 4.0 * p[..., 2:3] * F32_EPS * absum
        err = (k - p).abs()
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(k_int, p_int))
        within = bool((err[..., :2] <= bound[..., :2]).all())
        counts_exact = bool(torch.equal(k[..., 2], p[..., 2]))

        feats = torch.arange(F, device=dev)
        idx = ((local[:, None] * F + feats[None, :]) * B
               + binned.long()).reshape(-1)
        src = torch.stack([gf * live, hf * live, live], -1)[:, None, :] \
            .expand(N, F, 3).reshape(-1, 3)
        kernel_ms = time_ms(torch, lambda: H.level_histogram(
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
               "float_within_bound": within, "counts_exact": counts_exact,
               "max_abs_err": float(err.max().item()),
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": in_bytes + out_bytes, "ops": ops}
        emit({"phase": "kernel_vs_plain", **row})
        rows.append(row)
        if not (bitwise and within and counts_exact):
            raise AssertionError(f"level_hist disagrees with its plain "
                                 f"version at width {width}: {row}")
    ctx["hist_rows"] = rows
    return {"widths": list(WIDTHS), "all_agree": True}


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
        """Host syncs in a fit of ``num_trees`` trees: CUDA sync debug
        mode warns once for every synchronizing call."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                train(binned, y,
                      dataclasses.replace(cfg, num_iterations=num_trees),
                      bin_upper=bin_upper)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message) for w in caught)

    # the boosting loop must not wait on the device: after a warm-up fit
    # (one-off start-up syncs), a 1-tree and a 3-tree fit make the same
    # syncs — set-up and the final transfer only
    syncs_of(1)
    syncs = {t: syncs_of(t) for t in (1, 3)}
    if syncs[1] != syncs[3]:
        raise AssertionError(f"host syncs grow with the tree count: {syncs}")
    torch.cuda.synchronize()

    H.hist_kernel_launches = 0
    t0 = time.perf_counter()
    result = train(binned, y, cfg, bin_upper=bin_upper)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = H.hist_kernel_launches
    ctx["launches"] = {"level_hist": launches}
    ctx["main_inputs"] = (binned, y, bin_upper, cfg)

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
           "syncs_per_fit": syncs[3],
           "logloss_first": lls[0], "logloss_last": lls[-1],
           "fit_mrow_trees_per_s": N * booster.num_trees / fit_s / 1e6,
           "score_mrow_trees_per_s": N * booster.num_trees / score_s / 1e6,
           "card": ctx["smi"]}
    if launches != expected:
        raise AssertionError(f"level_hist launched {launches} times in the "
                             f"fit, expected {expected}")
    if not all(b <= a + 1e-7 for a, b in zip(lls, lls[1:])) \
            or not lls[-1] < lls[0]:
        raise AssertionError(f"training logloss does not fall: {lls}")
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
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch import train

    binned, y, bin_upper, cfg = ctx["main_inputs"]
    cfg = dataclasses.replace(cfg, num_iterations=5)
    binned_d = torch.as_tensor(binned.astype(np.uint8), device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(binned_d, y, cfg, bin_upper=bin_upper)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}   # device time by kernel name without template/arguments
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            base = e.name.replace("(anonymous namespace)::", "")
            name = re.sub(r"[<(].*$", "", base).strip()
            by_name[name] = by_name.get(name, 0.0) \
                + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    hist_us = sum(v for k, v in by_name.items() if "level_hist" in k)
    return {"trees": 5, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
            "device_idle_share": 1 - busy_us / wall_us if busy_us
            else "not measured",
            "level_hist_share_of_busy": hist_us / busy_us if busy_us
            else "not measured",
            "kernel_names": len(by_name),
            "top_ms": {k: v / 1e3 for k, v in top}}


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
    # the card sums histograms with atomics and reductions in another
    # order than the CPU: float32 rounding only, far below 1e-4 relative
    rel = abs(ll["cuda"] - ll["cpu"]) / abs(ll["cpu"])
    out = {"roots_equal": roots_equal, "logloss_cuda": ll["cuda"],
           "logloss_cpu": ll["cpu"], "rel_diff": rel, "tol": 1e-4}
    if not roots_equal or rel > 1e-4:
        raise AssertionError(f"card and CPU fits disagree: {out}")
    return out


def kernel_table(ctx):
    rows = ctx["hist_rows"]
    return {"kernels": [{
        "name": "level_hist",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/level_hist.cu",
        "replaces": "mmlspark_tpu/models/gbdt/hist_pallas.py:60",
        "launches": ctx["launches"]["level_hist"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # times summed over the six level widths of one depth-6 tree
        "ms": sum(r["kernel_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in rows),
        "per": "sum over widths " + ",".join(map(str, WIDTHS)),
    }]}


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
                     ("card_vs_cpu", phase_card_vs_cpu)):
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
