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
     on ``cpu`` through the port;
  6. quantized kernel vs plain: the int16 (q16) and int8 (q8)
     level-histogram kernel against its plain version at the bench
     shape for every level width — bitwise, and bitwise between two
     launches — with CUDA-event timings of the kernel, the plain
     version and one int64 ``index_add_`` call, and the byte bound;
  7. quantized main path: the 20-tree bench fit under
     ``MMLSPARK_TORCH_HIST_QUANT=q16`` (then q8), with the kernels'
     launch counts over each fit, the training logloss per tree, host
     syncs, two fits bitwise equal, and the fit rate; then the f32 and
     the q16 fit with ``MMLSPARK_TORCH_HIST_SUB=1``, and the kernels'
     device time per tree with subtraction off and on (torch.profiler);
  8. card vs CPU, quantized: the 100k-row 5-tree fit under q16 on
     ``cuda`` and on ``cpu``.

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
            base = e.name.replace("(anonymous namespace)::", "")
            name = re.sub(r"[<(].*$", "", base).strip()
            by_name[name] = by_name.get(name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    return wall_ms, by_name


def boosters_equal(a, b):
    return all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("split_feature", "threshold_bin", "threshold_value",
                         "node_value", "count", "tree_weights"))


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

        idx = H.flat_index(binned, local, F, B)
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
    if launches != expected or quant_launches:
        raise AssertionError(f"level_hist launched {launches} times in the "
                             f"fit, expected {expected}; level_hist_quant "
                             f"{quant_launches}, expected 0")
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

    from mmlspark_tpu_torch import train

    binned, y, bin_upper, cfg = ctx["main_inputs"]
    cfg = dataclasses.replace(cfg, num_iterations=5)
    binned_d = torch.as_tensor(binned.astype(np.uint8), device="cuda")
    wall_ms, by_name = device_ms_by_kernel(
        torch, lambda: train(binned_d, y, cfg, bin_upper=bin_upper))
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    hist_ms = sum(v for k, v in by_name.items() if "level_hist" in k)
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
    # the card sums histograms with atomics and reductions in another
    # order than the CPU: float32 rounding only, far below 1e-4 relative
    rel = abs(ll["cuda"] - ll["cpu"]) / abs(ll["cpu"])
    out = {"roots_equal": roots_equal, "logloss_cuda": ll["cuda"],
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
                   "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations",
                   "bytes": in_bytes + out_bytes, "ops": ops}
            emit({"phase": "kernel_quant_vs_plain", **row})
            rows[quant].append(row)
            if not (bitwise and repeat):
                raise AssertionError(f"level_hist_quant[{quant}] disagrees "
                                     f"at width {width}: {row}")
    ctx["quant_rows"] = rows
    return {"quants": list(QUANTS), "widths": list(WIDTHS),
            "all_bitwise": True}


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
            row["trees_equal_to_sub_off"] = boosters_equal(
                res.booster, sub_off["q16"])
        binned_d = torch.as_tensor(binned.astype(np.uint8), device="cuda")
        for sub in ("0", "1"):
            with knobs(quant, sub):
                wall_ms, by_name = device_ms_by_kernel(torch, lambda: train(
                    binned_d, y, dataclasses.replace(cfg, num_iterations=5),
                    bin_upper=bin_upper))
            hist_ms = sum(v for k, v in by_name.items()
                          if "level_hist" in k or "dequantize" in k)
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


def kernel_table(ctx):
    def entry(name, source, replaces, launches, rows):
        # times summed over the six level widths of one depth-6 tree
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["kernel_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "library_ms": sum(r["library_ms"] for r in rows),
            "per": "sum over widths " + ",".join(map(str, WIDTHS)),
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
                     ("card_vs_cpu_quant", phase_card_vs_cpu_quant)):
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
