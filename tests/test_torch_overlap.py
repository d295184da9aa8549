"""The overlapped train step (``dist.steps.make_train_step(overlap=True)``)
against the sequential one, on the CPU.

- Three gloo ranks, spawned once for the module, run reduced gemma3-1b
  with two pattern blocks (f32) for three steps of Base-2, each of the
  five methods with and without ``overlap`` (and DSGD-momentum with
  ``flatten_gossip``): parameters, method state and losses equal bit
  for bit, and the mixer sends the same messages and bytes (with
  ``flatten_gossip``, the same bytes in one message per group and slot,
  as the reference's per-group mixers send them).
- In one process, with a mixer whose exchanges complete when asked:
  each group's exchange is issued before an earlier group's is waited
  on, gradient tracking's two mixes of a group stay in order, and the
  result equals ``method.step`` with the same mixer bit for bit.
- ``overlap`` with ``compression`` raises ``ValueError``, as the
  reference's does; the groups come output end first.
"""
import numpy as np
import pytest
import torch

import torch_ckpt_ranks
from repro.topology import TopologySpec as JSpec
from repro.topology import build_schedule as jbuild
from repro_torch.configs import get_config
from repro_torch.dist import steps as S
from repro_torch.launch import distributed as D
from repro_torch.models import model as TM
from repro_torch.optim.decentralized import METHOD_NAMES, make_method

N, STEPS, ETA, SEQ, B = 3, 3, 0.05, 16, 2
CASES = [(m, False, ov) for m in METHOD_NAMES for ov in (False, True)] \
    + [("dsgdm", True, False), ("dsgdm", True, True)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg():
    return get_config("gemma3-1b").reduced(num_blocks=2)


@pytest.fixture(scope="module")
def ranks():
    params = {k: v.numpy() for k, v in
              TM.init(_cfg(), seed=0, dtype=torch.float32,
                      device="cpu").state_dict().items()}
    per_rank = D.spawn_local(torch_ckpt_ranks.overlap_cases, N,
                             device="cpu", timeout=300,
                             args=(params, CASES, STEPS, ETA, SEQ, B))
    return per_rank


def _same_bits(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same_bits(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
    else:
        assert got == want


@pytest.mark.parametrize("method", METHOD_NAMES)
def test_overlap_equals_sequential_bit_for_bit(ranks, method):
    for res in ranks:
        seq, ovl = res[(method, False, False)], res[(method, False, True)]
        assert ovl["overlap"] and not seq["overlap"]
        _same_bits(ovl["params"], seq["params"])
        _same_bits(ovl["state"], seq["state"])
        assert ovl["losses"] == seq["losses"]
        assert np.isfinite(ovl["losses"]).all()
        assert ovl["sent"] == seq["sent"]


def test_overlap_with_flatten_gossip(ranks):
    """Each group sends one flat buffer per slot: the same bytes, one
    message per group where the sequential step sends one."""
    groups = len(S.overlap_groups(TM.init(_cfg(), device="cpu")
                                  .state_dict()))
    plan = jbuild(JSpec("base", N, 1)).as_ppermute_plan()
    for rank, res in enumerate(ranks):
        seq, ovl = res[("dsgdm", True, False)], res[("dsgdm", True, True)]
        _same_bits(ovl["params"], seq["params"])
        _same_bits(ovl["state"], seq["state"])
        assert ovl["losses"] == seq["losses"]
        sends = sum(1 for s in range(STEPS)
                    for sp in plan.rounds[s % len(plan)].slots
                    for src, _ in sp.perm if src == rank)
        assert seq["sent"]["messages"] == sends
        assert ovl["sent"] == {"messages": sends * groups,
                               "bytes": seq["sent"]["bytes"]}
        # and the unflattened step's bytes: the f32 tree each send
        assert seq["sent"]["bytes"] == res[("dsgdm", False, True)][
            "sent"]["bytes"]


def test_overlap_with_compression_raises():
    with pytest.raises(ValueError, match="overlap"):
        S.make_train_step(_cfg(), None, compression="int8", overlap=True)


def test_overlap_groups_come_output_end_first():
    keys = list(TM.init(_cfg(), device="cpu").state_dict())
    groups = S.overlap_groups(keys)
    assert [g[0].split(".")[0] for g in groups] == \
        ["final_norm", "stack", "stack", "stack", "embed"]
    assert "stack.blocks.1" in groups[1][0] and "stack.blocks.0" in \
        groups[2][0] and "prologue" in groups[3][0]
    assert sorted(k for g in groups for k in g) == sorted(keys)
    enc = S.overlap_groups(["encoder.stack.blocks.0.0.w",
                            "encoder.stack.blocks.1.0.w",
                            "encoder.final_norm.scale", "lm_head.w"])
    assert enc == [["lm_head.w"], ["encoder.final_norm.scale"],
                   ["encoder.stack.blocks.1.0.w"],
                   ["encoder.stack.blocks.0.0.w"]]


class _LaterMixer:
    """A mixer whose exchanges complete only when asked (a fixed
    averaging map), recording the order of issues and completions."""

    def __init__(self):
        self.events = []

    def mix(self, tree):
        return {k: (0.75 * v + 0.25 * torch.roll(v, 1, 0))
                for k, v in tree.items()}

    def issue(self, tree, r):
        self.events.append(("issue", next(iter(tree))))
        return tree

    def complete(self, tree):
        self.events.append(("complete", next(iter(tree))))
        return self.mix(tree)


@pytest.mark.parametrize("method", METHOD_NAMES)
def test_overlapped_update_schedule_and_bits(method):
    rng = np.random.default_rng(3)
    keys = ["embed.table", "stack.blocks.0.0.w", "stack.blocks.1.0.w",
            "final_norm.scale"]
    params = {k: torch.from_numpy(rng.standard_normal((N, 4, 5))
                                  .astype(np.float32)) for k in keys}
    grads = {k: torch.from_numpy(rng.standard_normal((N, 4, 5))
                                 .astype(np.float32)) for k in keys}
    m = make_method(method)
    opt = m.init(params)
    if opt:
        first = next(iter(opt))
        opt[first] = {k: v + 0.1 for k, v in opt[first].items()}
    mixer = _LaterMixer()
    got_p, got_s = S._overlapped_update(m, params, grads, opt, mixer, 0,
                                        ETA, S.overlap_groups(keys))
    want_p, want_s = m.step(params, grads, opt, mixer.mix, ETA)
    _same_bits({k: v.numpy() for k, v in got_p.items()},
               {k: v.numpy() for k, v in want_p.items()})
    for sk in want_s:
        _same_bits({k: v.numpy() for k, v in got_s[sk].items()},
                   {k: v.numpy() for k, v in want_s[sk].items()})
    ev = mixer.events
    # the second group is issued before the first is waited on
    assert ev.index(("issue", "stack.blocks.1.0.w")) \
        < ev.index(("complete", "final_norm.scale"))
    issued = [k for what, k in ev if what == "issue"]
    assert len(issued) == 4 * m.mixes_per_step
    in_flight, most = 0, 0
    for what, _ in ev:
        in_flight += 1 if what == "issue" else -1
        most = max(most, in_flight)
    assert most == S.OVERLAP_WINDOW
    if m.mixes_per_step == 2:     # each group's mixes in order
        for k in keys:
            i = [j for j, e in enumerate(ev) if e[1] == k]
            assert [ev[j][0] for j in i] == ["issue", "complete"] * 2
