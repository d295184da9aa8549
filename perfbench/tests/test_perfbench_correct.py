"""What decides ``correct``, at a size a test run holds, on the CPU: a
sound run of each runner passes its cell's limits; the control (the
float8 reference put in the program's place) and each fault the cell can
have, planted under the timed path, do not.  The look for a card is
skipped: the runners are driven directly on the CPU's plain kernels."""
from __future__ import annotations

import pytest
import torch

from perfbench import lib
from perfbench.tests import cases

TRAIN = lib.load_module("runners", "train.py")
SERVE = lib.load_module("runners", "serve.py")
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _train(fault=None, controls=False, witness=True):
    return TRAIN.run(config=cases.SEAMLESS, traffic=cases.train_traffic(),
                     seed=SEED, seconds=0.2, trace=False, device="cpu",
                     fault=fault, controls=controls, witness=witness)


def _serve(fault=None, controls=False, cell="grok-chat"):
    return SERVE.run(config=cases.GROK, traffic=cases.serve_traffic(cell),
                     seed=SEED, seconds=0.2, trace=False, device="cpu",
                     fault=fault, controls=controls)


def test_train_sound_run_passes_and_control_fails():
    """A sound run on the program's callable-mix path, whose update takes
    no self-weight (the path that folds it in rounds the payload at a
    third of its value, PERF.md's first open question)."""
    res = _train(controls=True)
    assert lib.correct(res["checks"]), res["checks"]
    assert res["steps"] >= 1 and res["metrics"]["train_tokens_per_s"] > 0
    limits = cases.train_traffic()["limits"]
    control = {k: [res["control"][k], lim] for k, lim in limits.items()}
    assert not lib.correct(control), control


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_mix"])
def test_train_fault_fails(fault):
    res = _train(fault)
    assert not lib.correct(res["checks"]), res["checks"]


@pytest.mark.parametrize("cell", ["grok-chat", "grok-longprompt"])
def test_serve_sound_run_passes_and_control_fails(cell):
    res = _serve(controls=True, cell=cell)
    assert lib.correct(res["checks"]), res["checks"]
    assert res["failed"] == 0 and res["metrics"]["ttft_ms_p95"] > 0
    limits = cases.serve_traffic(cell)["limits"]
    control = {k: [res["control"][k], lim] for k, lim in limits.items()}
    assert not lib.correct(control), control


@pytest.mark.parametrize("cell,fault", [
    ("grok-chat", "token"), ("grok-chat", "half_batch"),
    ("grok-chat", "kv_write"), ("grok-longprompt", "slot")])
def test_serve_fault_fails(cell, fault):
    """Each fault a serving cell can have; one slot's wrong tokens are
    caught where the cell compares ``slot_gap`` (PERF.md §6)."""
    res = _serve(fault, cell=cell)
    assert not lib.correct(res["checks"]), res["checks"]


def test_nan_is_not_correct():
    assert not lib.correct({"x": [float("nan"), 1.0]})
    assert lib.correct({"x": [0.5, 1.0]})


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in lib.manifest()["workloads"]])
def test_cell_on_the_card(card, cell):
    """A short run of each cell on the card: one result line, correct."""
    import json
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "5", "--trace", "0"], cwd=lib.REPO,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["kind"] == card
