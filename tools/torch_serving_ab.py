#!/usr/bin/env python3
"""Serving of two checkouts of the port on one card: phase
``serving_path`` of each checkout's ``chip_smoke.py``, each run in its own
process, in the order A, B, B, A.

    python3 tools/torch_serving_ab.py ROOT_A ROOT_B

Each run fits the serving bench's model on the card and serves it as the
phase does (64 closed-loop clients for 5 s per arm; the phase's own gates
hold). Prints one JSON line per run — QPS, p50 / p99 and a loaded
batch's scoring time of each arm, in-process and, where the checkout
measures it, with the clients in a child process — then the card's name
and power limit. Needs a CUDA card; run it from either root.
"""

import json
import subprocess
import sys

RUN = r"""
import json, sys
sys.path.insert(0, ".")
import chip_smoke as C
ctx = {"smi": C.nvidia_smi_line(), "launches": {}}
out = C.phase_serving(ctx)
row = {"continuous_p50_ms": out["continuous"]["p50_ms"],
       "bin_row_us": out["bin_row_us"]}
for arm in ("on", "off"):
    a = out[f"batched_{arm}"]
    row[arm] = {k: a["sustained"][k] for k in ("qps", "p50_ms", "p99_ms")}
    row[arm]["score_ms_per_batch"] = a["load_server"]["score_ms_per_batch"]
    child = a.get("sustained_child_clients")
    if child:
        row[arm]["child_clients"] = {k: child[k] for k in (
            "qps", "p50_ms", "p99_ms", "score_ms_per_batch")}
print("RESULT " + json.dumps(row), flush=True)
"""


def run(root):
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"serving run in {root} failed (exit "
                       f"{proc.returncode}):\n{proc.stderr[-4000:]}")


def main():
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = sys.argv[1:]
    for label, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        print(json.dumps({"run": label, "root": root, **run(root)}),
              flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
