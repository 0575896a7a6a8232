"""Card times of kernel rows 1, 2, 2', 5, 6, 7 and 8 (PERF.md §6) for two
source trees on one card, in turns: A, B, B, A.

    python3 kernel_ab.py A_ROOT B_ROOT      # e.g. a parent commit's
                                            # ``git archive`` and "."

Each turn is a fresh interpreter (``--turn ROOT``) that imports ROOT's
``chip_smoke.py`` (which puts ROOT/src first on the path), builds ROOT's
kernels into ROOT/build and runs its phase 2 (``phase_kernels``: every
kernel against its plain version at the table's shapes, timed with CUDA
events), then prints the rows' card times as one JSON line.  The parent
prints a table of the four turns, each row's two runs per tree and the
change of the better one, and names the rows that moved by more than 5 %.
Card only.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

ROWS = {"batched_gram": "1", "batched_lowrank_apply": "2",
        "batched_lowrank_apply_int8": "2'", "batched_gram_mixed": "5",
        "batched_project_quantize": "6", "flash_attention": "7",
        "flash_attention_hd256": "7 (hd 256)", "ssd_scan": "8"}
MOVED = 0.05


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
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1])["ms"])
    print(f"row: A runs | B runs (ms) -> B / A of the better runs")
    moved = []
    for name, row in ROWS.items():
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
