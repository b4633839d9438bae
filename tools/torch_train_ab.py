#!/usr/bin/env python3
"""The bench-shape fit of two checkouts of the port on one card: phases
``main_path`` and ``profile`` of each checkout's ``chip_smoke.py``, each
run in its own process, in the order A, B, B, A.

    python3 tools/torch_train_ab.py [--max-bin B] ROOT_A ROOT_B

Each run builds its checkout's kernels, fits the 2M-row, 20-tree binary
bench model as phase ``main_path`` does (its gates hold: 120
``level_hist`` launches, two fits bitwise equal) and profiles a 5-tree
fit as phase ``profile`` does. With ``--max-bin B`` (past 256: uint16
ids, the histogram kernels' uint16 instances) it also bins the same rows
at B bins and fits them on the float32, q16 and q8 planes as phase
``breadth_path`` does: each ``train`` once to capture its step, then
once timed (host clock to a synchronize), with its launches per kernel.
Prints one JSON line per run — the fit's wall and rate, host syncs per
fit, the profiled fit's wall and the device's idle share (of the fit as
it runs: the replayed captured step where the checkout has one), and the
wide fits' ``train`` s — then the card's name and power limit. Needs a
CUDA card; run it from either root.
"""

import json
import subprocess
import sys

RUN = r"""
import json, sys
sys.path.insert(0, ".")
import chip_smoke as C
ctx = {"smi": C.nvidia_smi_line(), "launches": {}}
main = C.phase_main(ctx)
prof = C.phase_profile(ctx)
row = {k: main[k] for k in ("fit_s", "fit_mrow_trees_per_s",
                            "syncs_per_fit", "launches")}
# the profile as the fit runs: replayed (``captured``) where the
# checkout captures its boosting step, else the eager fit's
fit_prof = prof.get("captured", prof)
row.update({"profile_wall_ms": fit_prof["wall_ms"],
            "device_busy_ms": fit_prof["device_busy_ms"],
            "device_idle_share": fit_prof["device_idle_share"],
            "step": main.get("step"), "capture": main.get("capture")})
WIDE = int(sys.argv[1])
if WIDE:
    import dataclasses
    import numpy as np
    import torch
    from mmlspark_tpu_torch import BinMapper, train
    x, y = C.make_data(C.N)
    mapper = BinMapper.fit(x[:100_000], max_bin=WIDE)
    binned = mapper.transform(x, np.uint16 if WIDE > 256 else np.uint8)
    bin_upper = mapper.bin_upper_values(WIDE)
    cfg = dataclasses.replace(ctx["main_inputs"][3], max_bin=WIDE)
    for plane in ("off", "q16", "q8"):
        with C.knobs(quant=plane):
            train(binned, y, cfg, bin_upper=bin_upper)
            _, wall, launches = C.counted_fit(torch, lambda: train(
                binned, y, cfg, bin_upper=bin_upper))
        row[f"max_bin_{WIDE}_{plane}"] = {"train_s": wall,
                                          "launches": launches}
print("RESULT " + json.dumps(row), flush=True)
"""


def run(root, max_bin):
    proc = subprocess.run([sys.executable, "-c", RUN, str(max_bin)],
                          cwd=root,
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"training run in {root} failed (exit "
                       f"{proc.returncode}):\n{proc.stderr[-4000:]}")


def main():
    args = sys.argv[1:]
    max_bin = 0
    if args[:1] == ["--max-bin"] and len(args) > 1:
        max_bin, args = int(args[1]), args[2:]
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = args
    for label, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        print(json.dumps({"run": label, "root": root,
                          **run(root, max_bin)}), flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
