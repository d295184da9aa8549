"""The port's topology registry (``repro_torch.topology``, a numpy copy)
against the reference's: for every registered topology at a few (n, k),
the same W(r) matrices and dense stack bit for bit, the same schedule
length, maximum degree and finite-time law, and the same canonical spec
JSON.  Configurations the reference rejects are rejected by the port."""
import numpy as np
import pytest

from repro.core import mixing as jmixing
from repro.topology import TopologySpec as JSpec
from repro.topology import build_schedule as jbuild
from repro.topology import registered_names as jnames
from repro_torch.core import mixing
from repro_torch.topology import TopologySpec, build_schedule, \
    registered_names

CONFIGS = [(1, 1), (3, 1), (5, 1), (8, 1), (12, 2), (21, 2), (25, 4)]
NAMES = jnames()


def test_registries_hold_the_same_names():
    assert registered_names() == NAMES
    assert registered_names(include_aliases=True) == jnames(
        include_aliases=True)


@pytest.mark.parametrize("n,k", CONFIGS)
@pytest.mark.parametrize("name", NAMES)
def test_schedule_matches_reference(name, n, k):
    try:
        want = jbuild(JSpec(name=name, n=n, k=k))
    except ValueError:
        with pytest.raises(ValueError):
            build_schedule(TopologySpec(name=name, n=n, k=k))
        return
    got = build_schedule(TopologySpec(name=name, n=n, k=k))
    assert got.spec.to_json() == want.spec.to_json()
    assert TopologySpec.from_json(want.spec.to_json()).to_json() \
        == want.spec.to_json()
    assert len(got) == len(want)
    assert got.max_degree == want.max_degree
    assert got.finite_time == want.finite_time
    assert got.label == want.label
    for r in range(len(want)):
        assert np.array_equal(got.W(r), want.W(r))
    steps = 2 * len(want) + 1
    jW, jidx = want.as_dense_stack(steps)
    tW, tidx = got.as_dense_stack(steps, device="cpu")
    assert np.array_equal(tW.numpy().view(np.int32),
                          np.asarray(jW).view(np.int32))
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("name,n,k", [("base", 21, 2), ("base", 3, 1),
                                      ("ring", 21, None),
                                      ("one_peer_exp", 16, None)])
def test_consensus_utilities_match_reference(name, n, k):
    got = build_schedule(TopologySpec(name=name, n=n, k=k))
    want = jbuild(JSpec(name=name, n=n, k=k))
    np.testing.assert_array_equal(
        mixing.consensus_error_curve(got, 2 * len(got), seed=1, d=4),
        jmixing.consensus_error_curve(want, 2 * len(want), seed=1, d=4))
    assert mixing.is_finite_time_convergent(got) \
        == jmixing.is_finite_time_convergent(want)
    assert got.effective_neighbors() == want.effective_neighbors()
    assert got.effective_neighbors(per_round=True) \
        == want.effective_neighbors(per_round=True)
    assert got.degrades_gracefully == want.degrades_gracefully


def test_unported_artifacts_raise():
    """Every artifact is ported now.  The padded stack equals the
    reference's bit for bit and is built once per (device, length); a
    length below the period raises, as in the reference.  The slot plan
    (its parity is below) is compiled once."""
    sched = build_schedule(TopologySpec(name="base", n=5, k=1))
    want = jbuild(JSpec(name="base", n=5, k=1))
    L = len(sched)
    for length in (None, L, L + 3):
        jW, jidx = want.as_padded(4, length)
        tW, tidx = sched.as_padded(4, length, device="cpu")
        assert np.array_equal(tW.numpy().view(np.int32),
                              np.asarray(jW).view(np.int32))
        assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    assert sched.as_padded(4, L + 3, "cpu")[0] \
        is sched.as_padded(9, L + 3, "cpu")[0]
    with pytest.raises(ValueError, match="cannot pad"):
        sched.as_padded(4, L - 1, device="cpu")
    assert sched.as_ppermute_plan() is sched.as_ppermute_plan()


PLAN_CASES = [(name, n, k) for n in (3, 4, 5, 8, 12)
              for name, k in (("base", 1), ("base", 2), ("base", 3),
                              ("simple_base", 2), ("one_peer_exp", None),
                              ("ring", None))]


@pytest.mark.parametrize("name,n,k", PLAN_CASES)
def test_ppermute_plan_matches_reference(name, n, k):
    """The distributed runtime's artifact: the same slots (perms and
    receive weights) and self weights as the reference's
    ``compile_schedule``, and the plan executed in numpy equals W(r) X
    and the reference's executor bit for bit."""
    from repro.core.ppermute_plan import apply_round_plan_np as japply
    from repro_torch.core.ppermute_plan import apply_round_plan_np
    try:
        want_sched = jbuild(JSpec(name=name, n=n, k=k))
    except ValueError:
        with pytest.raises(ValueError):
            build_schedule(TopologySpec(name=name, n=n, k=k))
        return
    got_sched = build_schedule(TopologySpec(name=name, n=n, k=k))
    got, want = got_sched.as_ppermute_plan(), want_sched.as_ppermute_plan()
    assert (got.name, got.n, len(got), got.max_slots) \
        == (want.name, want.n, len(want), want.max_slots)
    X = np.random.default_rng(n).standard_normal((n, 3, 5))
    for r, (g, w) in enumerate(zip(got.rounds, want.rounds)):
        assert np.array_equal(g.self_weight, w.self_weight)
        assert g.num_messages == w.num_messages
        assert [s.perm for s in g.slots] == [s.perm for s in w.slots]
        for gs, ws in zip(g.slots, w.slots):
            assert np.array_equal(gs.recv_weight, ws.recv_weight)
        out = apply_round_plan_np(g, X)
        assert np.array_equal(out, japply(w, X))
        np.testing.assert_allclose(
            out, np.tensordot(got_sched.W(r), X, axes=([1], [0])),
            rtol=0, atol=1e-12)


def test_spec_from_cli_matches_reference():
    from repro.topology import spec_from_cli as jspec_from_cli
    from repro_torch.topology import spec_from_cli
    for value, k in (("base", 2), ('{"name":"base","k":3}', None),
                     ("ring", None), (TopologySpec("base", 6, 1), None)):
        jvalue = JSpec("base", 6, 1) if isinstance(value, TopologySpec) \
            else value
        assert spec_from_cli(value, n=6, k=k).to_json() \
            == jspec_from_cli(jvalue, n=6, k=k).to_json()
    with pytest.raises(ValueError, match="n=5"):
        spec_from_cli('{"name":"base","n":5}', n=6)


@pytest.mark.parametrize("name,n,k", [("ring", 8, None), ("base", 3, 1),
                                      ("base", 12, 1), ("one_peer_exp", 8,
                                                        None),
                                      ("one_peer_exp", 16, None)])
def test_bytes_per_node_per_round_matches_reference(name, n, k):
    """The send-side volume the compressed wire accounting multiplies by
    ``CompressionConfig.wire_bytes`` (DESIGN.md Sec. 13)."""
    got = build_schedule(TopologySpec(name=name, n=n, k=k))
    want = jbuild(JSpec(name=name, n=n, k=k))
    for param_bytes in (1, 100, 4 * 10 ** 6, 1_003_622_400):
        assert got.bytes_per_node_per_round(param_bytes) \
            == want.bytes_per_node_per_round(param_bytes)
