"""Resuming ``repro_torch.launch.train`` as ``repro.launch.train`` resumes.

The reference's launcher trains the reduced model 6 steps with a
checkpoint every 3 (``step-3`` after step 3 ran, and ``step-6`` at the
end).  From ``step-3`` alone the reference resumes, and so does the port
from the same checkpoint renamed (``convert.convert_checkpoint``): both run
steps 3, 4 and 5 and give the same losses (``rtol=1e-4``, the tolerance of
tests/test_torch_train.py).  Batch 3 runs twice: ``step-3`` was saved after
it, at optimizer count 4, and the loop restarts at 3, so each resumed run
ends at count 7 where the uninterrupted one ended at 6 (the reference's
behavior, ROADMAP.md queue 3, kept in the port).  Also: ``--resume`` with
no checkpoint starts at step 0, and the launcher writes ``step-<s>`` every
``--checkpoint-every`` steps (not at 0) and at the end, with no ``tmp-``
left.
"""
import json
import os
import shutil
import sys

import numpy as np
from torch_parity import torch_one_thread  # noqa: F401

from repro.launch import train as jlaunch
from repro_torch import convert
from repro_torch.launch import train as tlaunch

ARGV = ["--reduced", "--steps", "6", "--seq", "16", "--batch", "4",
        "--rank", "4", "--block-size", "32", "--update-every", "2",
        "--log-every", "1"]


def _ref_main(monkeypatch, *argv) -> list:
    """The reference launcher's ``main`` with ``argv``; its per-step
    metrics records."""
    out = argv[argv.index("--metrics-out") + 1]
    monkeypatch.setattr(sys, "argv", ["repro.launch.train", *argv])
    jlaunch.main()
    with open(out) as f:
        return json.load(f)


def _count(directory: str, step: int, name: str) -> int:
    """The step count ``name`` recorded in ``step-<step>``."""
    path = os.path.join(directory, f"step-{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        rec = next(r for r in json.load(f)["leaves"] if r["name"] == name)
    return int(np.load(os.path.join(path, rec["file"])))


def test_resume_matches_reference_and_repeats_the_batch(tmp_path, monkeypatch,
                                                        capsys):
    full, ref, port = (str(tmp_path / d) for d in ("full", "ref", "port"))
    jfull = _ref_main(monkeypatch, *ARGV, "--checkpoint-dir", full,
                      "--checkpoint-every", "3", "--metrics-out",
                      str(tmp_path / "full.json"))
    assert sorted(os.listdir(full)) == ["step-3", "step-6"]
    shutil.copytree(os.path.join(full, "step-3"),
                    os.path.join(ref, "step-3"))
    convert.convert_checkpoint(ref, port, to="port")
    capsys.readouterr()
    jresumed = _ref_main(monkeypatch, *ARGV, "--checkpoint-dir", ref,
                         "--checkpoint-every", "3", "--resume",
                         "--metrics-out", str(tmp_path / "ref.json"))
    assert "resumed from step 3" in capsys.readouterr().out
    tresumed = tlaunch.main(ARGV + [
        "--device", "cpu", "--checkpoint-dir", port, "--checkpoint-every",
        "3", "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out

    # batch 3 again, in both packages, with the same losses
    assert [r["step"] for r in tresumed] == [r["step"] for r in jresumed] \
        == [3, 4, 5]
    np.testing.assert_allclose([r["loss"] for r in tresumed],
                               [r["loss"] for r in jresumed], rtol=1e-4)
    assert jresumed[0]["loss"] != jfull[3]["loss"]
    # step-3 holds count 4 (batches 0-3 taken); each resumed run ends one
    # optimizer step past the uninterrupted one
    assert _count(full, 3, "1::.count::.value") == 4
    assert _count(full, 6, "1::.count::.value") == 6
    assert _count(ref, 6, "1::.count::.value") == 7
    assert _count(port, 6, "1::.count") == 7
    assert _count(port, 6, "1::.inner::precond::.count") == 7
    assert sorted(os.listdir(port)) == ["step-3", "step-6"]


def test_resume_without_a_checkpoint_starts_at_zero(tmp_path, capsys):
    d = str(tmp_path / "ck")
    log = tlaunch.main(ARGV + ["--steps", "4", "--device", "cpu",
                               "--checkpoint-dir", d, "--checkpoint-every",
                               "2", "--resume"])
    assert "resumed" not in capsys.readouterr().out
    assert [r["step"] for r in log] == [0, 1, 2, 3]
    assert sorted(os.listdir(d)) == ["step-2", "step-4"]
    assert _count(d, 4, "1::.count") == 4
