"""Dry-run driver (port of repro/launch/dryrun.py): plans one cell of an
architecture, shape and mesh on the ``meta`` device, on one host.

    python -m repro_torch.launch.dryrun --arch paper-lm-100m --shape \
        train_4k --devices 8 --mesh 2x4:data,model --smoke --out r.json

The process joins a fake process group of ``--devices`` ranks (rank 0; the
others need not exist: ``torch.testing._internal.distributed.fake_pg``),
where the reference forces that many XLA host devices, and builds the mesh
with launch/mesh.py (the production mesh of 256, or 512 with
``--multi-pod``, unless ``--mesh`` names one).  It prints the report
(launch/dryrun_lib.py ``run_cell``) as JSON and writes it to ``--out``.
Nothing runs on a card.
"""
from __future__ import annotations

import argparse
import json
import math
import os


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Multi-pod dry-run driver")
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", required=True, choices=[
        "train_4k", "prefill_32k", "decode_32k", "long_500k"])
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--optimizer", default="sketchy",
                   choices=["sketchy", "shampoo", "adam"])
    p.add_argument("--devices", type=int, default=None,
                   help="ranks the host may fake (tests); the mesh takes "
                        "as many as it has")
    p.add_argument("--mesh", default=None,
                   help="override mesh e.g. '2x4:data,model'")
    p.add_argument("--skip-probes", action="store_true")
    p.add_argument("--smoke", action="store_true",
                   help="reduced config + tiny shape (tests)")
    p.add_argument("--skip-full", action="store_true")
    p.add_argument("--rules", default=None,
                   help="JSON logical-rule overrides (perf experiments)")
    p.add_argument("--opt-overrides", default=None,
                   help="JSON OptimizerConfig overrides")
    p.add_argument("--model-overrides", default=None,
                   help="JSON ModelConfig overrides (perf experiments)")
    p.add_argument("--microbatches", type=int, default=None,
                   help="gradient-accumulation microbatches (train cells)")
    p.add_argument("--out", default=None, help="write report JSON here")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.dryrun_lib import run_cell
    from repro_torch.launch.mesh import make_mesh

    args = parse_args(argv)
    shape = axes = None
    if args.mesh:
        shape_s, axes_s = args.mesh.split(":")
        shape = tuple(int(x) for x in shape_s.split("x"))
        axes = tuple(axes_s.split(","))
    world = math.prod(shape) if shape else (512 if args.multi_pod else 256)
    if args.devices is not None and args.devices < world:
        raise SystemExit(f"a mesh of {world} ranks needs --devices >= "
                         f"{world}, got {args.devices}")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = None if shape is None else \
            make_mesh(shape, axes, device_type="cpu")
        rule_overrides = json.loads(args.rules) if args.rules else None
        if rule_overrides:
            rule_overrides = {k: tuple(v) if isinstance(v, list) else v
                              for k, v in rule_overrides.items()}
        report = run_cell(
            args.arch, args.shape, multi_pod=args.multi_pod,
            optimizer=args.optimizer, mesh=mesh,
            skip_probes=args.skip_probes, skip_full=args.skip_full,
            rule_overrides=rule_overrides,
            opt_overrides=(json.loads(args.opt_overrides)
                           if args.opt_overrides else None),
            model_overrides=(json.loads(args.model_overrides)
                             if args.model_overrides else None),
            microbatches=args.microbatches, smoke=args.smoke)
    finally:
        dist.destroy_process_group()
    text = json.dumps(report, indent=2, default=float)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return report


if __name__ == "__main__":
    main()
