"""The port's distributed runtime (``repro_torch.dist``,
``repro_torch.launch.{distributed,train}``) on the CPU, against the
reference.

- ``ref.gossip_mix_ref`` equals the reference's oracle bit for bit
  where one order exists (up to two slots); with more, the oracle's
  ``jnp.sum`` may add in another order, so within 4 f32 ulps of the
  terms' magnitude ``sum_s |w_s b_s|`` (in bf16, one bf16 rounding
  step of it); the interpret-mode
  Pallas kernels (both entry points) within the same 4 ulps: XLA may
  contract the kernel's ``acc + w*b`` into an FMA (ROADMAP queue 3).
- Four gloo ranks on the CPU, one node each, spawned once for the module
  (``launch.distributed.spawn_local``, a ``file://`` store under
  ``tmp_path``, one thread per rank, a join timeout):
  * the mixer of each topology family, every round from the same inputs,
    equals ``W(r) @ X`` within 1e-5 (the reference's
    ``tests/test_dist.py``), with and without ``flatten``; an int tensor
    passes through bit for bit; Base-2 at n = 3 runs in a subgroup of
    three ranks (one node idle each round); each rank sends the plan's
    messages and no more; the mixer's buckets (one grouped combine for
    both float tensors) equal one bucket per tensor bit for bit, with the
    same messages and bytes;
  * the compressed mixer (int8, fp8, int4; chunk 64, error feedback):
    its buckets of reference leaves (one grouped quantize and one grouped
    quantized combine per round for int8 and fp8) equal one bucket per
    leaf bit for bit, mixed values and residuals, and both send the
    plan's messages (one per payload field and leaf) and bytes (the
    codec's wire bytes per leaf);
  * DSGD-momentum on reduced gemma3-1b (two pattern blocks, f32) for 4
    steps equals the reference's own dense simulation (its step under
    ``jit``) within 2e-4 (``tests/test_dist.py``), and int8 + EF21
    DSGD-momentum within 1e-3 for the parameters and 1e-2 for the
    residuals (``tests/test_compress_dist.py``), with ``ct`` = 4.
- Each of the five methods (reduced gemma3-1b with one pattern block,
  3 steps) equals the port's simulation engine on the same parameters
  within 1e-5 (f32 sums in another order); gradient tracking mixes
  twice in a round, as the reference's ``dist/steps.py`` does.
- The launcher's three CPU ranks equal the port's simulation engine on
  the same parameters and batches: per-node losses within 1e-5; with
  ``--overlap`` its losses and bytes equal the sequential run's bit for
  bit; ``--ckpt-dir --ckpt-every 1`` leaves a ``latest`` and a node-mean
  ``ckpt`` that the reference's ``load_pytree`` reads; two
  processes started apart, one rank each, meet through the REPRO_*
  variables and train as one group.
- A rank that raises fails the spawn with its traceback; the entry
  points run on CUDA unless told otherwise, and ``nccl`` with more ranks
  than cards raises before anything starts.
"""
import os
import re
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks
from repro.compress import CompressionConfig as JCompressionConfig
from repro.configs import get_config as jget_config
from repro.data import synthetic as jsynthetic
from repro.kernels import ref as jref
from repro.kernels.gossip_mix import gossip_mix_pallas, \
    gossip_mix_slots_pallas
from repro.models import model as JM
from repro.optim.decentralized import make_method as jmake
from repro.topology import TopologySpec as JSpec
from repro.topology import build_schedule as jbuild
from repro_torch.compress import CompressionConfig
from repro_torch.configs import get_config
from repro_torch.convert import rank_slice, stack_ranks, tree_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.launch import distributed as D
from repro_torch.launch import train as T
from repro_torch.models import model as TM
from repro_torch.optim.decentralized import METHOD_NAMES, make_method
from repro_torch.sim.engine import simulate_decentralized
from repro_torch.topology import TopologySpec

N = 4
MIX_CASES = [(name, n, k, flatten)
             for name, n, k in (("base", 4, 1), ("base", 4, 2),
                                ("base", 4, 3), ("simple_base", 4, 2),
                                ("one_peer_exp", 4, None), ("ring", 4, None),
                                ("base", 3, 1))
             for flatten in (False, True)]
CMIX_CASES = [("int8", "base", 4, 1), ("fp8", "base", 4, 3),
              ("int8", "base", 3, 1), ("int4", "base", 4, 1)]
STEPS, ETA, B, SEQ, BLOCKS = 4, 0.05, 2, 16, 2
METHOD_STEPS = 3
INT8 = dict(codec="int8", chunk=256, error_feedback=True, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The module's own CPU work is many small ops: one intra-op thread
    keeps it from spinning against the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mix_inputs():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((N, 4, 6)).astype(np.float32),
            "b": rng.standard_normal((N, 3)).astype(np.float32),
            "count": rng.integers(-2**40, 2**40, (N, 2))}


def _cmix_inputs():
    """A flat dict with one reference leaf of two blocks, two leaves of
    one tensor each, an int tensor; and EF residuals for it."""
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((N, 4, 100)).astype(np.float32),
            "stack.blocks.0.0.w": rng.standard_normal((N, 5, 70)).astype(
                np.float32),
            "stack.blocks.1.0.w": rng.standard_normal((N, 5, 70)).astype(
                np.float32),
            "b": rng.standard_normal((N, 3)).astype(np.float32),
            "count": rng.integers(-2**40, 2**40, (N, 2))}
    ef = {k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in tree.items() if k != "count"}
    ef["count"] = tree["count"]
    return tree, ef


def _batches(step, vocab):
    raw = jsynthetic.token_batches(step, batch=N * B, seq=SEQ, vocab=vocab)
    return {k: v.reshape(N, B, SEQ) for k, v in raw.items()}


def _reference_training(jcfg, jparams, grad_fn, compression):
    """The reference's dense simulation, as its own ``tests/test_dist.py``
    runs it: per-node gradients by ``vmap`` and a jitted ``method.step``
    with ``W(step)``.  Returns the node-stacked parameters and state."""
    method = jmake("dsgdm",
                   compression=None if compression is None
                   else JCompressionConfig(**compression))
    sched = jbuild(JSpec("base", N, 1))
    pn = jax.tree.map(lambda p: jnp.broadcast_to(p[None], (N,) + p.shape)
                      + 0.0, jparams)
    state = method.init(pn)
    step = jax.jit(lambda p, g, s, W: method.step(p, g, s, W, ETA))
    for r in range(STEPS):
        batch = jax.tree.map(jnp.asarray, _batches(r, jcfg.vocab_size))
        pn, state = step(pn, grad_fn(pn, batch), state,
                         jnp.asarray(sched.W(r)))
    return pn, state


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of four gloo CPU ranks runs every distributed case."""
    store = tmp_path_factory.mktemp("dist")
    jcfg = jget_config("gemma3-1b").reduced(num_blocks=BLOCKS)
    jparams = JM.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    flat = {k: v.numpy()
            for k, v in tree_from_jax(jax.tree.map(np.asarray,
                                                   jparams)).items()}
    tree = _mix_inputs()
    one_block = {k: v.numpy() for k, v in TM.init(
        get_config("gemma3-1b").reduced(), seed=1,
        device="cpu").state_dict().items()}
    train_cases = [
        ("dsgdm", (flat, BLOCKS, None, STEPS, ETA, B, SEQ)),
        ("int8", (flat, BLOCKS, CompressionConfig(**INT8), STEPS, ETA, B,
                  SEQ))]
    train_cases += [(f"method-{m}", (one_block, 1, None, METHOD_STEPS, ETA,
                                     B, SEQ, m)) for m in METHOD_NAMES]
    ctree = _cmix_inputs()
    per_rank = D.spawn_local(
        torch_dist_ranks.all_cases, N,
        args=(tree, MIX_CASES, train_cases, ctree, CMIX_CASES),
        backend="gloo", device="cpu", timeout=300,
        init_method=f"file://{store}/store")
    out = {name: [r[name] for r in per_rank] for name in per_rank[0]}
    out["one-block"] = one_block
    out["tree"] = tree
    out["ctree"] = ctree[0]
    grad_fn = jax.jit(jax.vmap(jax.grad(
        lambda p, b: JM.loss_fn(jcfg, p, b)[0])))
    out["ref-dsgdm"] = _reference_training(jcfg, jparams, grad_fn, None)
    out["ref-int8"] = _reference_training(jcfg, jparams, grad_fn, INT8)
    return out


# ---------------------------------------------------------------------------
# the plain gossip combine against the reference's
# ---------------------------------------------------------------------------

def _ulps(a, b, scale):
    """|a - b| in f32 ulps of ``scale`` (the magnitude of the terms)."""
    return np.abs(a.astype(np.float64) - b) / np.spacing(
        np.maximum(np.abs(scale), np.float32(1e-30)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 2, 3, 5])
def test_gossip_mix_ref_matches_reference(S, dtype):
    rng = np.random.default_rng(S)
    bufs = rng.standard_normal((S, 37, 300)).astype(np.float32)
    w = rng.random(S).astype(np.float32)
    w /= w.sum()
    jbufs = jnp.asarray(bufs).astype(dtype)
    tbufs = torch.from_numpy(np.array(jbufs.astype(jnp.float32))).to(
        getattr(torch, dtype))
    want = np.asarray(jref.gossip_mix_ref(jbufs, jnp.asarray(w))
                      .astype(jnp.float32))
    terms = np.abs(w[:, None, None] * np.asarray(jbufs.astype(jnp.float32))
                   ).sum(axis=0)
    for got in (ref.gossip_mix_ref(tbufs, w),
                ref.gossip_mix_ref(list(tbufs), w),
                ops.gossip_mix(list(tbufs), w.tolist()),
                ops.gossip_mix(tbufs, torch.from_numpy(w))):
        assert got.dtype == tbufs.dtype and got.shape == (37, 300)
        g = got.float().numpy()
        if S <= 2:          # one order of at most two products
            assert np.array_equal(g.view(np.int32), want.view(np.int32))
        elif dtype == "float32":
            assert _ulps(g, want, terms).max() <= 4
        else:               # one bf16 rounding step of the terms
            assert (np.abs(g - want) <= 2.0 ** -8 * terms).all()
    if dtype == "float32":
        for kernel in (gossip_mix_pallas(jbufs, jnp.asarray(w),
                                         interpret=True),
                       gossip_mix_slots_pallas(tuple(jbufs), jnp.asarray(w),
                                               interpret=True)):
            k = np.asarray(kernel)
            g = ref.gossip_mix_ref(tbufs, w).numpy()
            assert _ulps(g, k, terms).max() <= 4


def test_gossip_mix_ref_sums_in_slot_order():
    # (1 + 2^-24) + 2^-24: slot order rounds to 1 twice; another order
    # would keep the 2^-23
    x = torch.tensor([[1.0]]), torch.tensor([[2.0 ** -24]])
    got = ref.gossip_mix_ref([x[0], x[1], x[1]], [1.0, 1.0, 1.0])
    assert float(got) == 1.0


def test_gossip_mix_raises_on_bad_input():
    a = torch.zeros(2, 3)
    with pytest.raises(ValueError):
        ops.gossip_mix([], [])
    with pytest.raises(ValueError):
        ops.gossip_mix([a, a], [1.0])


# ---------------------------------------------------------------------------
# the mixer on four gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", MIX_CASES, ids=str)
def test_mixer_round_equals_dense_matrix(ranks, case):
    name, n, k, flatten = case
    sched = jbuild(JSpec(name, n, k))
    got = [r[case] for r in ranks["mix"][:n]]
    for r in range(len(sched)):
        W = np.asarray(sched.W(r), np.float64)
        for key in ("a", "b"):
            X = ranks["tree"][key][:n]
            want = np.tensordot(W, X, axes=([1], [0]))
            mixed = np.concatenate([g["rounds"][r][key] for g in got])
            assert mixed.dtype == np.float32
            np.testing.assert_allclose(mixed, want, rtol=0, atol=1e-5)
        counts = np.concatenate([g["rounds"][r]["count"] for g in got])
        assert np.array_equal(counts, ranks["tree"]["count"][:n])


@pytest.mark.parametrize("case", MIX_CASES, ids=str)
def test_mixer_sends_the_plans_messages(ranks, case):
    name, n, k, flatten = case
    plan = jbuild(JSpec(name, n, k)).as_ppermute_plan()
    f32 = 4 * sum(v[0].size for key, v in ranks["tree"].items()
                  if key != "count")
    for rank, res in enumerate(ranks["mix"][:n]):
        sends = sum(1 for rp in plan.rounds for sp in rp.slots
                    for src, _ in sp.perm if src == rank)
        per_send = 1 if flatten else 2          # one message per tensor
        assert res[case]["sent"] == {"messages": sends * per_send,
                                     "bytes": sends * f32}


@pytest.mark.parametrize("case", MIX_CASES, ids=str)
def test_bucketed_mixer_equals_one_combine_per_tensor(ranks, case):
    n, flatten = case[1], case[3]
    floats = sum(1 for v in ranks["tree"].values()
                 if np.issubdtype(v.dtype, np.floating))
    for res in ranks["mix"][:n]:
        res = res[case]
        assert res["sent"] == res["per-tensor sent"]
        assert res["combines"] == [1] * len(res["rounds"])
        assert res["per-tensor combines"] == [1 if flatten else floats] \
            * len(res["rounds"])
        for got, want in zip(res["rounds"], res["per-tensor rounds"]):
            assert got.keys() == want.keys()
            for key in got:
                assert got[key].dtype == want[key].dtype
                assert np.array_equal(got[key].view(np.uint8),
                                      want[key].view(np.uint8))


@pytest.mark.parametrize("case", CMIX_CASES, ids=str)
def test_bucketed_compressed_mixer_equals_one_bucket_per_leaf(ranks, case):
    codec, n = case[0], case[2]
    grouped = codec in ("int8", "fp8")
    for res in ranks["cmix"][:n]:
        res = res[case]
        # int8 / fp8: one grouped quantize and one grouped combine for the
        # round's one bucket, or one of each per float reference leaf
        assert res["calls"] == [[1, 1] if grouped else [0, 0]] \
            * len(res["rounds"])
        assert res["per-leaf calls"] == [[3, 3] if grouped else [0, 0]] \
            * len(res["rounds"])
        assert res["sent"] == res["per-leaf sent"]
        for got, want in zip(res["rounds"], res["per-leaf rounds"]):
            for g, w in zip(got, want):     # mixed values, residuals
                assert g.keys() == w.keys()
                for key in g:
                    assert g[key].dtype == w[key].dtype
                    assert np.array_equal(g[key].view(np.uint8),
                                          w[key].view(np.uint8)), key


@pytest.mark.parametrize("case", CMIX_CASES, ids=str)
def test_compressed_mixer_sends_the_plans_messages(ranks, case):
    codec, name, n, k = case
    plan = jbuild(JSpec(name, n, k)).as_ppermute_plan()
    cfg = CompressionConfig(codec=codec, chunk=64)
    tree = ranks["ctree"]
    leaves = [["a"], ["stack.blocks.0.0.w", "stack.blocks.1.0.w"], ["b"]]
    wire = sum(cfg.wire_bytes(sum(tree[key][0].size for key in g))
               for g in leaves)
    for rank, res in enumerate(ranks["cmix"][:n]):
        sends = sum(1 for rp in plan.rounds for sp in rp.slots
                    for src, _ in sp.perm if src == rank)
        assert res[case]["sent"] == {"messages": sends * 2 * len(leaves),
                                     "bytes": sends * wire}
        for mixed, _ in res[case]["rounds"]:
            assert np.array_equal(mixed["count"],
                                  tree["count"][rank:rank + 1])


def test_ranks_outside_a_subgroup_take_no_part(ranks):
    assert not [c for c in ranks["mix"][3] if c[1] == 3]


# ---------------------------------------------------------------------------
# training on four gloo ranks against the reference's simulation
# ---------------------------------------------------------------------------

def _max_err(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(float(np.abs(got[k].numpy() - want[k].numpy()).max())
               for k in want)


def _stacked(results, field):
    return stack_ranks([{k: torch.from_numpy(v)
                         for k, v in r[field].items()} for r in results])


def test_dsgdm_matches_reference_simulation(ranks):
    pn, _ = ranks["ref-dsgdm"]
    want = tree_from_jax(jax.tree.map(np.asarray, pn), node_axis=True)
    got = _stacked(ranks["dsgdm"], "params")
    assert _max_err(got, want) < 2e-4
    assert all(len(r["losses"]) == STEPS and np.isfinite(r["losses"]).all()
               for r in ranks["dsgdm"])


def test_int8_ef_dsgd_matches_reference_simulation(ranks):
    pn, state = ranks["ref-int8"]
    want = tree_from_jax(jax.tree.map(np.asarray, pn), node_axis=True)
    got = _stacked(ranks["int8"], "params")
    assert _max_err(got, want) < 1e-3
    want_ef = tree_from_jax(jax.tree.map(np.asarray, state["ef"]),
                            node_axis=True)
    got_ef = stack_ranks([{k: torch.from_numpy(v) for k, v in
                           r["state"]["ef"].items()} for r in ranks["int8"]])
    assert _max_err(got_ef, want_ef) < 1e-2
    assert int(state["ct"]) == STEPS
    assert [r["state"]["ct"] for r in ranks["int8"]] == [STEPS] * N


@pytest.mark.parametrize("method", METHOD_NAMES)
def test_each_method_matches_port_simulation(ranks, method):
    """The five methods through the callable-mixer branch (gradient
    tracking mixes twice in a round) against the port's simulation
    engine with the dense W(r), in f32: within 1e-5."""
    cfg = get_config("gemma3-1b").reduced()

    def batches(step):
        raw = jsynthetic.token_batches(step, batch=N * B, seq=SEQ,
                                       vocab=cfg.vocab_size)
        return {k: v.reshape(N, B, SEQ) for k, v in raw.items()}

    res = simulate_decentralized(
        loss_fn=lambda p, b: TM.loss_fn(cfg, p, b)[0],
        params={k: torch.from_numpy(v) for k, v in
                ranks["one-block"].items()},
        method=make_method(method), schedule=TopologySpec("base", N, 1),
        batches=batches, steps=METHOD_STEPS, eta=ETA, device="cpu")
    got = _stacked(ranks[f"method-{method}"], "params")
    assert _max_err(got, res.params) < 1e-5


def test_int8_sends_fewer_bytes_than_f32(ranks):
    for plain, comp in zip(ranks["dsgdm"], ranks["int8"]):
        assert comp["sent"]["bytes"] * 3 < plain["sent"]["bytes"]


# ---------------------------------------------------------------------------
# the launcher and the spawn helper
# ---------------------------------------------------------------------------

LAUNCH = T.TrainOptions(arch="gemma3-1b", reduced=True, steps=3, batch=6,
                        seq=16, log_every=1)


@pytest.fixture(scope="module")
def launched():
    """The launcher's three CPU ranks, sequential steps."""
    return T.launch(LAUNCH, nproc=3, backend="gloo", device="cpu",
                    timeout=240)


def test_launcher_matches_port_simulation(launched):
    results = launched
    got = np.asarray([r["losses"] for r in results])
    np.testing.assert_allclose(got, _per_node_sim_losses(3, 3, 6, 16),
                               rtol=0, atol=1e-5)
    assert [r["device"] for r in results] == ["cpu"] * 3
    # round r: Base-2 at n = 3 pairs (0, 1), (0, 2), (0, 1)
    f32 = 4 * sum(p.numel() for p in TM.init(
        get_config("gemma3-1b").reduced(), seed=0,
        device="cpu").state_dict().values())
    assert [r["sent"]["bytes"] for r in results] == [3 * f32, 2 * f32, f32]


def _per_node_sim_losses(n, steps, batch, seq):
    """The port's simulation engine's loss of each node at each step,
    (n, steps), for the launcher's parameters and batches."""
    cfg = get_config("gemma3-1b").reduced()
    per_node = []

    def loss_fn(p, b):
        loss = TM.loss_fn(cfg, p, b)[0]
        per_node.append(float(loss.detach()))
        return loss

    def batches(step):
        raw = jsynthetic.token_batches(step, batch=batch, seq=seq,
                                       vocab=cfg.vocab_size)
        return {k: v.reshape(n, batch // n, seq) for k, v in raw.items()}

    simulate_decentralized(
        loss_fn=loss_fn, params=TM.init(cfg, seed=0, device="cpu")
        .state_dict(), method=make_method("dsgdm"),
        schedule=TopologySpec("base", n, 1), batches=batches, steps=steps,
        eta=0.01, device="cpu")
    return np.asarray(per_node).reshape(steps, n).T


def test_launcher_ranks_started_apart_meet_through_the_environment(
        tmp_path):
    """Each process of a deployment is one rank, described by the
    REPRO_* variables (the coordinator a ``file://`` store here)."""
    env = {"PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src"),
           "PATH": "/usr/bin:/bin",
           "REPRO_COORDINATOR_ADDRESS": f"file://{tmp_path}/store",
           "REPRO_NUM_PROCESSES": "2", "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma3-1b", "--reduced", "--device", "cpu", "--steps", "2",
         "--batch", "4", "--seq", "16", "--log-every", "1"],
        env={**env, "REPRO_PROCESS_ID": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    got = np.zeros((2, 2))
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        for rank, step, loss in re.findall(
                r"rank (\d) step +(\d+) +loss ([\d.]+)", out):
            got[int(rank), int(step)] = float(loss)
    assert "topology spec" in outs[0][0]
    np.testing.assert_allclose(got, _per_node_sim_losses(2, 2, 4, 16),
                               rtol=0, atol=1e-4)      # printed to 4 places


def test_spawn_reports_the_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        D.spawn_local(torch_dist_ranks.fail_on_rank_one, 2, device="cpu",
                      timeout=120, init_method=f"file://{tmp_path}/store")


def test_rank_slices_stack_back():
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "n": torch.arange(3)}
    state = {"u": tree, "ct": 5}
    parts = [rank_slice(state, r) for r in range(3)]
    assert parts[1]["u"]["w"].shape == (1, 4) and parts[1]["ct"] == 5
    back = stack_ranks(parts)
    assert back["ct"] == 5
    assert all(torch.equal(back["u"][k], tree[k]) for k in tree)
    with pytest.raises(ValueError):
        stack_ranks([{"ct": 1}, {"ct": 2}])


def test_distributed_config_from_env_and_flags():
    env = {"REPRO_COORDINATOR_ADDRESS": "localhost:1234",
           "REPRO_NUM_PROCESSES": "3", "REPRO_PROCESS_ID": "2"}
    assert D.config_from_env(env) == D.DistributedConfig("localhost:1234",
                                                         3, 2)
    assert D.config_from_env({}) == D.DistributedConfig()
    ap = __import__("argparse").ArgumentParser()
    D.add_distributed_args(ap)
    args = ap.parse_args(["--process-id", "1"])
    assert D.config_from_args(args, env) == D.DistributedConfig(
        "localhost:1234", 3, 1)
    with pytest.raises(ValueError, match="coordinator"):
        D.DistributedConfig(num_processes=2, process_id=0)
    with pytest.raises(ValueError):
        D.DistributedConfig("h:1", 2, 2)


def test_entry_points_default_to_cuda_and_nccl_needs_a_card_per_rank():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    opts = T.TrainOptions(reduced=True, steps=1, batch=2, seq=8)
    for call in (lambda: T.launch(opts, nproc=2),
                 lambda: D.spawn_local(torch_dist_ranks.fail_on_rank_one, 2),
                 lambda: D.rank_device("gloo", None, 0, 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="nccl"):
        D.rank_device("nccl", "cpu", 0, 1)
    with pytest.raises(ValueError, match="backend"):
        D.rank_device("mpi", "cpu", 0, 1)
    assert D.rank_device("gloo", "cpu", 3, 4) == torch.device("cpu")


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="one card per rank"):
        D.rank_device("nccl", "cuda", 0, 3)
    with pytest.raises(ValueError, match="one card per rank"):
        D.spawn_local(torch_dist_ranks.fail_on_rank_one, 3, backend="nccl")
    assert D.rank_device("gloo", "cuda", 2, 3) == torch.device("cuda", 0)
    assert D.rank_device("nccl", "cuda", 0, 1) == torch.device("cuda", 0)


def test_launcher_overlap_losses_equal_sequential(launched):
    """``--overlap``: the launcher's losses and bytes equal the sequential
    run's bit for bit."""
    results = T.launch(replace(LAUNCH, overlap=True), nproc=3,
                       backend="gloo", device="cpu", timeout=240)
    assert [r["losses"] for r in results] == \
        [r["losses"] for r in launched]
    assert [r["sent"] for r in results] == [r["sent"] for r in launched]


def test_launcher_ckpt_dir_leaves_latest_and_ckpt(tmp_path):
    """``--ckpt-dir --ckpt-every 1``: "latest" (after step 1, one shard
    file per rank) and the node-mean "ckpt" load in the reference's
    ``load_pytree``."""
    from repro.checkpoint import load_pytree as jload

    T.main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
            "--nproc", "3", "--steps", "2", "--batch", "6", "--seq", "16",
            "--overlap", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    jcfg = jget_config("gemma3-1b").reduced()
    shapes = jax.eval_shape(lambda k: JM.init(jcfg, k, jnp.float32),
                            jax.random.PRNGKey(0))
    stacked = jax.tree.map(lambda s: jnp.zeros((3,) + s.shape, s.dtype),
                           shapes)
    latest = jload({"params": stacked, "opt": {"u": stacked},
                    "step": jnp.int32(0)}, str(tmp_path), name="latest")
    assert int(latest["step"]) == 1
    assert sorted(f for f in os.listdir(tmp_path / "latest")
                  if f.startswith("shards")) == \
        [f"shards-p{r}.npz" for r in range(3)]
    mean = jload(jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                              shapes), str(tmp_path))
    for leaf in jax.tree.leaves(mean) + jax.tree.leaves(latest):
        assert np.isfinite(np.asarray(leaf)).all()
    # a node-mean differs from each node's parameters after a step
    assert not np.array_equal(np.asarray(mean["embed"]["table"]),
                              np.asarray(latest["params"]["embed"]["table"]
                                         [0]))

