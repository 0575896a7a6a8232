"""Card times of kernel rows 1, 2, 2', 4, 5, 6, 7 and 8 (PERF.md §6) for two
source trees on one card, in turns: A, B, B, A.

    python3 kernel_ab.py A_ROOT B_ROOT      # e.g. a parent commit's
                                            # ``git archive`` and "."

Each turn is a fresh interpreter (``--turn ROOT``) that imports ROOT's
``chip_smoke.py`` (which puts ROOT/src first on the path), builds ROOT's
kernels into ROOT/build and runs its phase 2 (``phase_kernels``: every
kernel against its plain version at the table's shapes, timed with CUDA
events), then prints the rows' card times as one JSON line.  Rows 7 and
8's JSON shapes are launch-bound (host noise), so the parent also reads
from the turn's printed lines their S 4096 times and their main-path
shapes' device time alone (a CUDA graph of 50 calls): DEVICE_ROWS.  The parent
prints a table of the four turns, each row's two runs per tree and the
change of the better one, and names the rows that moved by more than 5 %.
Card only.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys

ROWS = {"batched_gram": "1", "batched_lowrank_apply": "2",
        "batched_lowrank_apply_int8": "2'", "lowrank_apply": "4",
        "batched_gram_mixed": "5",
        "batched_project_quantize": "6", "flash_attention": "7",
        "flash_attention_hd256": "7 (hd 256)", "ssd_scan": "8"}
MOVED = 0.05
# rows read from phase 2's printed lines: name -> (pattern, the time's unit)
DEVICE_ROWS = {
    "7 S 4096 hd 112": (r"flash_attention B=1 H=32 S=4096 hd=112 bf16: "
                        r"([0-9.]+) ms", "ms"),
    "7 S 4096 hd 256": (r"flash_attention B=1 H=8 S=4096 hd=256 bf16: "
                        r"([0-9.]+) ms", "ms"),
    "7 B 8 S 128 hd 64 alone": (r"flash_attention B=8 H=12 S=128 hd=64 "
                                r"device time per call \(CUDA graph of "
                                r"50\): kernel ([0-9.]+) us", "us"),
    "7 B 4 S 16 hd 112 alone": (r"flash_attention B=4 H=32 S=16 hd=112 "
                                r"device time per call \(CUDA graph of "
                                r"50\): kernel ([0-9.]+) us", "us"),
    "8 zamba2 S 4096": (r"ssd_scan B=1 S=4096 H=112 P=64 N=64 chunk=256 "
                        r"bf16: ([0-9.]+) ms", "ms"),
    "8 mamba2 S 4096": (r"ssd_scan B=1 S=4096 H=32 P=64 N=128 chunk=256 "
                        r"bf16: ([0-9.]+) ms", "ms"),
    "8 B 4 S 16 alone": (r"ssd_scan B=4 S=16 device time per call \(CUDA "
                         r"graph of 50\): ([0-9.]+) us", "us"),
}


def turn(root: str) -> None:
    import torch
    root = os.path.abspath(root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.build.build_all()
    out = smoke.phase_kernels(torch.device("cuda", 0))
    print(json.dumps({"root": root, "ms": {
        name: out[name]["ms"] for name in ROWS if name in out}}), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--turn"]:
        turn(sys.argv[2])
        return 0
    a, b = sys.argv[1:3]
    runs = []
    for root in (a, b, b, a):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--turn", root], capture_output=True,
                              text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr)
        if proc.returncode != 0:
            return proc.returncode
        ms = json.loads(proc.stdout.strip().splitlines()[-1])["ms"]
        for name, (pattern, _) in DEVICE_ROWS.items():
            found = re.search(pattern, proc.stdout)
            if found:
                ms[name] = float(found.group(1))
        runs.append(ms)
    print(f"row: A runs | B runs (ms) -> B / A of the better runs")
    moved = []
    rows = dict(ROWS, **{name: name for name in DEVICE_ROWS})
    for name, row in rows.items():
        if name not in runs[0] or name not in runs[1]:
            continue
        ta = (runs[0][name], runs[3][name])
        tb = (runs[1][name], runs[2][name])
        ratio = min(tb) / min(ta)
        if abs(ratio - 1) > MOVED:
            moved.append(row)
        print(f"{row} {name}: {ta[0]:.4f} {ta[1]:.4f} | {tb[0]:.4f} "
              f"{tb[1]:.4f} -> {ratio:.3f}")
    print(json.dumps({"a": a, "b": b, "runs": runs,
                      "moved_over_5_percent": moved}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
