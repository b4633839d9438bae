#!/usr/bin/env python3
"""The tree scorer of two checkouts, timed in turns on one CUDA card.

    python3 tools/torch_score_ab.py ROOT_A ROOT_B

Each ROOT is a checkout of this repository. First a process of ROOT_B
fits the two boosters every measurement scores, as ``chip_smoke.py``
fits them: the main path's (``bench.py``'s HIGGS-shaped 2,000,000 x 28
rows, binary, 20 trees, 63 leaves, depth 6) and the serving bench's
(``tools/bench_serving.py``'s 100,000 rows, 100 trees, 63 leaves, depth
6); it saves their state dicts and the binned rows to a temporary
directory. Then every measurement runs in a process of its own that
imports ``mmlspark_tpu_torch`` from its root (building that root's
``tree_score`` kernel), in the order A, B, B, A, so that two versions of
the kernel are compared on one card within one call. Each process loads
the boosters into its root's ``BoosterArrays`` and times one
``score_cuda.tree_score`` call on the card in three cases: the main
booster on the 2M uint8 bin ids (``predict_binned``), on the 2M raw
float32 rows with 1% NaN (``predict``, the estimator's transform), and
the served booster on 64 rows (a served batch's rung). A time is the
device time of one call: 20 calls queued behind a spin kernel
(``torch.cuda._sleep``) between two CUDA events, the median of 3 such
batches. A SHA-256 of each case's scores shows whether the two roots
compute the same bits. It prints one JSON line per measurement with the
card's name and power limit; a last line holds each case's times per
root and whether every root gave the same digests.
"""

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

N, F = 2_000_000, 28
SERVED_ROWS, RUNG = 100_000, 64
REPS, BATCHES = 20, 3
CASES = ("2M_uint8", "2M_raw", "rung64")


def make_data(n, seed=0):
    """The bench's HIGGS-shaped synthetic problem (``chip_smoke.py``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, F)).astype(np.float32)
    logit = (x[:, 0] * 1.2 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
             + 0.3 * np.sin(x[:, 4] * 3))
    y = (logit + rng.normal(size=n) * 0.5 > 0).astype(np.float64)
    return x, y


def serving_data(n, seed=0):
    """``tools/bench_serving.py``'s rows and label rule."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, F))
    y = (x[:, 0] - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
         + rng.normal(size=n) * 0.5 > 0).astype(np.float64)
    return x, y


def _import_port(root):
    sys.path.insert(0, os.path.abspath(root))
    import mmlspark_tpu_torch
    if not mmlspark_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {mmlspark_tpu_torch.__file__}, not "
                           f"from {root}")


def fit(root, store):
    """Fit both boosters on the card with ``root``'s port and save them."""
    _import_port(root)
    import numpy as np

    from mmlspark_tpu_torch import BinMapper, TrainConfig, train
    arrays = {}
    for name, (x, y), trees in (("main", make_data(N), 20),
                                ("served", serving_data(SERVED_ROWS), 100)):
        mapper = BinMapper.fit(x[:100_000], max_bin=255)
        binned = mapper.transform(x)
        cfg = TrainConfig(objective="binary", num_iterations=trees,
                          num_leaves=63, max_depth=6, min_data_in_leaf=20)
        booster = train(binned, y, cfg,
                        bin_upper=mapper.bin_upper_values(255)).booster
        state = booster.state_dict()
        meta = state.pop("booster_meta")
        arrays.update({f"{name}.{k}": v for k, v in state.items()})
        arrays[f"{name}.meta"] = np.array(json.dumps(meta))
        arrays[f"{name}.bins"] = binned.astype(np.uint8)[
            :N if name == "main" else RUNG]
    np.savez(os.path.join(store, "boosters.npz"), **arrays)


def device_ms(torch, fn):
    """Device time of one ``fn()`` in ms: ``REPS`` calls queued behind a
    spin kernel between two events, the median of ``BATCHES`` batches (a
    batch the host did not enqueue within the spin is run again with a
    longer spin)."""
    import numpy as np
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
            continue
        times.append(start.elapsed_time(end) / REPS)
    return float(np.median(times))


def measure(root, store):
    _import_port(root)
    import numpy as np
    import torch

    from mmlspark_tpu_torch.models.gbdt import score_cuda as S
    from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays
    saved = np.load(os.path.join(store, "boosters.npz"))

    def booster(name):
        state = {k.split(".", 1)[1]: saved[k] for k in saved.files
                 if k.startswith(name + ".") and k not in
                 (f"{name}.meta", f"{name}.bins")}
        state["booster_meta"] = json.loads(str(saved[f"{name}.meta"]))
        return BoosterArrays.from_state_dict(state)

    main, served = booster("main"), booster("served")
    x, _ = make_data(N)
    x[np.random.default_rng(5).random(x.shape) < 0.01] = np.nan
    cases = {
        "2M_uint8": (main.predict_binned_scorer("off", "cuda").tables,
                     torch.as_tensor(saved["main.bins"]).cuda()),
        "2M_raw": (main._scorer(True, "off", "cuda").tables,
                   torch.as_tensor(x).cuda()),
        "rung64": (served.predict_binned_scorer("off", "cuda").tables,
                   torch.as_tensor(saved["served.bins"]).cuda()),
    }
    ms, digests = {}, {}
    for name, (tables, xd) in cases.items():
        digests[name] = hashlib.sha256(
            S.tree_score(xd, tables).cpu().numpy().tobytes()).hexdigest()
        ms[name] = device_ms(torch, lambda: S.tree_score(xd, tables))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "card": smi, "device_ms": ms,
                      "sha256": digests}), flush=True)


def main(argv):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--fit", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--measure", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--store", help=argparse.SUPPRESS)
    parser.add_argument("roots", nargs="+")
    args = parser.parse_args(argv[1:])
    if args.fit:
        fit(args.roots[0], args.store)
        return 0
    if args.measure:
        measure(args.roots[0], args.store)
        return 0
    if len(args.roots) != 2:
        parser.error("give two roots")
    a, b = args.roots
    store = tempfile.mkdtemp(prefix="score_ab_")
    try:
        me = os.path.abspath(__file__)
        subprocess.run([sys.executable, me, "--fit", "--store", store, b],
                       check=True, timeout=900)
        times = {r: {c: [] for c in CASES} for r in (a, b)}
        digests = {c: set() for c in CASES}
        for root in (a, b, b, a):
            out = subprocess.run([sys.executable, me, "--measure",
                                  "--store", store, root],
                                 capture_output=True, text=True, check=True,
                                 timeout=900)
            line = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            for c in CASES:
                times[root][c].append(line["device_ms"][c])
                digests[c].add(line["sha256"][c])
    finally:
        shutil.rmtree(store, ignore_errors=True)
    print(json.dumps({"device_ms": {r: {c: sorted(v) for c, v in t.items()}
                                    for r, t in times.items()},
                      "same_bits": all(len(d) == 1
                                       for d in digests.values())}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
