"""The port's multi-process bring-up smoke and its training example, run
as a user runs them, on the CPU: ``scripts/launch_multiprocess_torch.sh``
starting 2 processes through the env contract (each prints its
``SMOKE_OK`` line, the all_reduce over both gives 2; a wrong
``--expect-processes`` makes the script exit 1), the smoke without a
card (an error naming ``--device cpu``), and
``examples/train_decentralized_torch.py --preset tiny --steps 12`` on 8
gloo ranks, whose own assertion is that the last-10 mean loss is below
the first-10."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SMOKE = [sys.executable, "-m", "repro_torch.launch.distributed", "--smoke",
         "--global-collective", "--device", "cpu"]


def _run(cmd, timeout=240):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "OMP_NUM_THREADS": "1"}
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_launch_script_smoke_on_two_processes():
    r = _run(["scripts/launch_multiprocess_torch.sh", "-p", "2", "--",
              *SMOKE, "--expect-processes", "2"])
    assert r.returncode == 0, r.stderr
    lines = sorted(l for l in r.stdout.splitlines()
                   if l.startswith("SMOKE_OK"))
    assert lines == [f"SMOKE_OK proc={i}/2 device=cpu local=1 global=2 "
                     f"local_sum=6 global_sum=2" for i in range(2)]
    assert "2 processes OK" in r.stdout
    bad = _run(["scripts/launch_multiprocess_torch.sh", "-p", "2", "--",
                *SMOKE, "--expect-processes", "3"])
    assert bad.returncode == 1
    assert "at least one process failed" in bad.stderr


def test_smoke_without_a_card_names_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run([sys.executable, "-m", "repro_torch.launch.distributed",
              "--smoke"])
    assert r.returncode != 0 and "--device cpu" in r.stderr
    one = _run(SMOKE)
    assert one.returncode == 0, one.stderr
    assert one.stdout.startswith("SMOKE_OK proc=0/1 device=cpu")


def test_train_example_loss_decreases():
    r = _run([sys.executable, "examples/train_decentralized_torch.py",
              "--device", "cpu", "--preset", "tiny", "--steps", "12"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "nodes=4  mesh=(4, 2)" in r.stdout
    assert "OK: loss decreased" in r.stdout
