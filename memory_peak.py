"""What is live on the card at the peak of a phase of chip_smoke.py: 7c
(deepseek-moe-16b served at full width with the monitor and the adapter),
or 9a (the vlm and audio families trained at full width, each run of
TRAIN_FULL traced apart).

    python3 memory_peak.py alone [PHASE]   # the phase first in its process
    python3 memory_peak.py script [PHASE]  # the whole chip_smoke.py, the
                                           # phase traced

PHASE is ``moe`` (7c, the default) or ``train-full`` (9a).

Records the caching allocator's history over the phase
(``torch.cuda.memory._record_memory_history``), replays its allocations and
frees, and prints the live blocks at the largest total, grouped by the
first frame of this repository that allocated them, with the call chain.
Needs one card.
"""
from __future__ import annotations

import collections
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402


def _chain(frames: list) -> list:
    return [f"{os.path.basename(f['filename'])}:{f['line']}:{f['name']}"
            for f in frames if "repro_torch" in f["filename"]
            or "chip_smoke" in f["filename"]]


def report(tag: str) -> None:
    """The live blocks at the peak of the recorded history."""
    trace = torch.cuda.memory._snapshot()["device_traces"][0]
    live, total, peak, at_peak = {}, 0, -1, {}
    for event in trace:
        if event["action"] == "alloc":
            live[event["addr"]] = (event["size"], event.get("frames", []))
            total += event["size"]
            if total > peak:
                peak, at_peak = total, dict(live)
        elif event["action"] == "free_requested" and event["addr"] in live:
            total -= live.pop(event["addr"])[0]
    print(f"[{tag}] peak of the traced live bytes: {peak}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()}")
    groups = collections.defaultdict(lambda: [0, 0, []])
    for size, frames in at_peak.values():
        chain = _chain(frames) or ["(no Python frame)"]
        group = groups[chain[0]]
        group[0] += size
        group[1] += 1
        group[2] = group[2] or chain
    for size, count, chain in sorted(groups.values(), key=lambda g: -g[0]):
        print(f"[{tag}] {size:>14} B in {count:>4} blocks: "
              f"{' < '.join(chain[:6])}")


def traced(phase, tag: str):
    def run(dev, *args):
        torch.cuda.memory._record_memory_history(max_entries=3_000_000,
                                                 stacks="python")
        out = phase(dev, *args)
        report(f"{tag} {' '.join(map(str, args[:2]))}".strip())
        torch.cuda.memory._record_memory_history(enabled=None)
        return out
    return run


# PHASE -> (chip_smoke's function, the argument tuples of its calls)
PHASES = {"moe": ("phase_moe_serve", [()]),
          "train-full": ("phase_train_full", chip_smoke.TRAIN_FULL)}


def main() -> int:
    argv = sys.argv[1:]
    if not torch.cuda.is_available() or not argv \
            or argv[0] not in ("alone", "script") \
            or argv[1:] not in ([], ["moe"], ["train-full"]):
        print(__doc__, file=sys.stderr)
        return 1
    name, calls = PHASES[argv[1] if argv[1:] else "moe"]
    if argv[0] == "script":
        setattr(chip_smoke, name, traced(getattr(chip_smoke, name),
                                         "script"))
        return chip_smoke.main()
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.build.build_all()
    for args in calls:
        traced(getattr(chip_smoke, name), "alone")(torch.device("cuda", 0),
                                                   *args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
