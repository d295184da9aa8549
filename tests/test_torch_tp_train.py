"""The tensor-parallel trainer (``repro_torch.dist.steps.make_train_step(
mesh=)``, autograd through ``dist.tp``'s collectives, the train
launcher's ``--mesh-data`` / ``--mesh-model`` / ``--production-mesh``)
on four gloo CPU ranks, against the port's one-model-rank step and the
reference.

One spawn for the module (``launch.distributed.spawn_local``, one
thread per rank, ``tests/torch_tp_train_ranks.py``) runs every mesh
case, each rank's shards cut by ``convert.shard_for_rank`` under the
train rules from the reference's reduced weights
(``tests/torch_moe_cases.pair``):

* gemma3-1b on (data 2, model 2), the 1-D rule (two nodes on "data",
  every matrix's last dim on "model"): each of the five methods for 2
  steps, the shards put back together (``convert.unshard_ranks``, which
  also holds the ranks that share a slice to the same bits: the
  replicated tensors are bit-equal across model ranks), equals the
  port's one-model-rank distributed step within 1e-5 (f32 sums in
  another order); DSGD-momentum equals the reference's dense simulation
  within 2e-4, as ``tests/test_torch_dist.py`` holds it; ``overlap=True``
  equals the sequential step bit for bit;
* grok-1-314b on (data 2, model 2), the 2-D rule (one node, contraction
  dims on "data"): with 2 rows a node (split over "data"), with 3
  (whole on every rank) and with ``embed_lookup_replicated``, the
  step-0 loss and the gradients put back together within 1e-4 of
  ``jax.value_and_grad`` of the reference's ``loss_fn`` over the node's
  whole batch, the routing and the aux loss over that batch included;
  deepseek-v3-671b the same way with 2 rows (MLA, the shared experts on
  the rank's rows, the untied head's f32 product, the MTP term);
* gemma3-1b on a 3-axis mesh (pod 2, data 1, model 2): one node, its
  rows split over "pod", against the reference the same way;
* mamba2-2.7b on (data 2, model 2): each node's loss and gradients, a
  Mamba layer's ``conv_w`` gathered whole, against the reference;
* the compressed mixer (int8, EF) over the node axis of (data 2, model
  2): each shard chunked on its own, the hash indexed by the node's row
  (``me * rows``), equals the reference's ``compressed_dense_mix`` of the
  shard trees within 1e-6, residuals bit for bit;
* the launcher's ``train_rank`` over (data 2, model 2) with
  checkpoints: the reference's ``load_pytree`` reads "latest" and the
  node-mean "ckpt" bit for bit; the port's ``load_pytree(placement=)``
  restores "latest" onto (data 2, model 2), (data 2, model 1) and one
  rank, here in the parent, and a copy the ranks saved on (data 2,
  model 1) onto (data 2, model 2), each bit for bit.

The launcher: ``--nproc 4 --mesh-model 2`` (and with ``--mesh-data 2``)
prints ``--nproc 2``'s per-node losses within 1e-5; ``--production-mesh
single`` on 4 ranks raises ``ValueError`` naming 256 ranks.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_train_ranks
from torch_moe_cases import _jvalue_and_grad, err, pair
from repro.compress import CompressionConfig as JCompressionConfig
from repro.compress import compressed_dense_mix
from repro.data import synthetic as jsynthetic
from repro.optim.decentralized import make_method as jmake
from repro.topology import TopologySpec as JSpec
from repro.topology import build_schedule as jbuild
from repro_torch.convert import tree_from_jax, tree_to_jax, unshard_ranks
from repro_torch.dist.sharding import make_rules, param_partition_specs
from repro_torch.launch import train as T
from repro_torch.launch.distributed import spawn_local
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.decentralized import METHOD_NAMES

N, B, SEQ, STEPS, ETA, CKPT_STEPS = 2, 2, 16, 2, 0.05, 3
MESH = (2, 2), ("data", "model")
MESH3 = (2, 1, 2), ("pod", "data", "model")
INT8 = dict(codec="int8", chunk=64, error_feedback=True, seed=3)
LAUNCH = ["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
          "--steps", "3", "--batch", "4", "--seq", "16", "--log-every",
          "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _full(arch):
    return {k: v.numpy() for k, v in pair(arch)[3].state_dict().items()}


def _batches(arch, nodes, rows, steps, seq=SEQ):
    """Per step, ``(nodes, rows, seq)`` of ``token_batches``."""
    vocab = pair(arch)[1].vocab_size
    out = []
    for step in range(steps):
        raw = jsynthetic.token_batches(step, batch=nodes * rows, seq=seq,
                                       vocab=vocab)
        out.append({k: v.reshape(nodes, rows, seq) for k, v in raw.items()})
    return out


def _compress_inputs():
    """Two nodes' trees of three of reduced gemma3-1b's tensors, the
    embedding table, a matrix of a pattern block and a norm scale
    (node-stacked, numpy; the reference's eager codec compiles each
    leaf's shapes), and EF residuals for them."""
    full = {k: v for k, v in _full("gemma3-1b").items()
            if k in ("embed.table", "stack.blocks.0.5.mlp.down.w",
                     "final_norm.scale")}
    rng = np.random.default_rng(4)
    params = {k: np.stack([v, v + 0.01 * rng.standard_normal(
        v.shape).astype(np.float32)]) for k, v in full.items()}
    ef = {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in params.items()}
    return params, ef


#: (arch, mesh, nodes, rows a node, tokens a row, make_train_step's
#: options, the axes that split the rows)
GRAD_CASES = {
    "grok-2-rows": ("grok-1-314b", MESH, 1, 2, 12, {}, ("data",)),
    "grok-3-rows": ("grok-1-314b", MESH, 1, 3, 12, {}, ()),
    "grok-embed-whole": ("grok-1-314b", MESH, 1, 2, 12,
                         {"embed_lookup_replicated": True}, ("data",)),
    "deepseek-2-rows": ("deepseek-v3-671b", MESH, 1, 2, 12, {},
                        ("data",)),
    "gemma-3-axis": ("gemma3-1b", MESH3, 1, 2, SEQ, {}, ("pod",)),
    "mamba": ("mamba2-2.7b", MESH, N, B, SEQ, {}, ())}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of four gloo CPU ranks runs every mesh case."""
    store = tmp_path_factory.mktemp("tp_train")
    cases = [dict(kind="methods", arch="gemma3-1b", mesh=MESH,
                  params=_full("gemma3-1b"),
                  batches=_batches("gemma3-1b", N, B, STEPS),
                  methods=("dsgdm",) + tuple(
                      m for m in METHOD_NAMES if m != "dsgdm"),
                  steps=STEPS, overlap=True, eta=ETA)]
    for arch, mesh, nodes, rows, seq, kw, _ in GRAD_CASES.values():
        cases.append(dict(kind="grads", arch=arch, mesh=mesh,
                          params=_full(arch), step_kw=kw,
                          batches=_batches(arch, nodes, rows, 1, seq)))
    params, ef = _compress_inputs()
    cases.append(dict(kind="compress", arch="gemma3-1b", mesh=MESH,
                      params=params, ef=ef, compression=INT8, round=0,
                      t=5))
    ckpt_dir = tmp_path_factory.mktemp("tp_ckpt")
    cases.append(dict(kind="ckpt", arch="gemma3-1b", mesh=MESH,
                      opts=T.TrainOptions(
                          arch="gemma3-1b", reduced=True, steps=CKPT_STEPS,
                          batch=4, seq=16, log_every=CKPT_STEPS,
                          remat=False, mesh_model=2, ckpt_dir=str(ckpt_dir),
                          ckpt_every=1)))
    per_rank = spawn_local(torch_tp_train_ranks.train_cases, 4,
                           args=(cases,), backend="gloo", device="cpu",
                           timeout=300,
                           init_method=f"file://{store}/store")
    out = {"methods": [r[0] for r in per_rank],
           "compress": [r[-2] for r in per_rank],
           "ckpt": [r[-1] for r in per_rank], "ckpt_dir": str(ckpt_dir)}
    for i, name in enumerate(GRAD_CASES):
        out[name] = [r[1 + i] for r in per_rank]
    return out


def _mesh(layout):
    return Mesh(dict(zip(layout[1], layout[0])))


def _specs(arch, layout):
    full = {k: torch.from_numpy(v) for k, v in _full(arch).items()}
    return param_partition_specs(full, make_rules(
        _mesh(layout), arch_name=pair(arch)[1].name, context="train"))


def _node_whole(arch, layout, per_rank, pick, node_axis="data"):
    """Each node's flat dict put back together from its ranks' shards
    (``pick(rank_result)``), in node order; ``unshard_ranks`` raises if
    two ranks that hold the same slice differ by a bit."""
    specs = _specs(arch, layout)
    mesh = _mesh(layout)
    sub = Mesh({a: (1 if a == node_axis else s)
                for a, s in mesh.shape.items()})
    nodes = {}
    for r in per_rank:
        node = r["coords"].get(node_axis, 0)
        nodes.setdefault(node, []).append(
            {k: torch.from_numpy(v) for k, v in pick(r).items()})
    return [unshard_ranks(nodes[i], specs, sub) for i in sorted(nodes)]


# ---------------------------------------------------------------------------
# the 1-D rule against the one-model-rank step and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHOD_NAMES)
def test_methods_equal_one_model_rank_step(ranks, method):
    """Each method, 2 steps on (data 2, model 2): the losses and the
    node's parameters after each step within 1e-5 of the one-model-rank
    distributed step's; the replicated tensors bit-equal across the
    node's model ranks (``unshard_ranks``)."""
    per_rank = ranks["methods"]
    for step in range(STEPS):
        nodes = _node_whole("gemma3-1b", MESH, per_rank,
                            lambda r: r[(method, False)]["shards"][step])
        for r in per_rank:
            if r["coords"]["model"]:
                continue
            one = r[(method, False, "one")]
            got = r[(method, False)]
            assert abs(got["losses"][step] - one["losses"][step]) <= 1e-5
            whole = nodes[r["node"]]
            for k, v in one["params"][step].items():
                assert err(whole[k], v) <= 1e-5, (method, step, k)
    # the model ranks of a node report its loss bit for bit
    for r in per_rank:
        peer = next(q for q in per_rank if q["node"] == r["node"])
        assert r[(method, False)]["losses"] == peer[(method, False)][
            "losses"]


def test_dsgdm_matches_reference_simulation(ranks):
    """DSGD-momentum on the mesh against the reference's dense
    simulation (per-node gradients by ``vmap``, a jitted
    ``method.step`` with ``W(step)``), within 2e-4."""
    jparams = pair("gemma3-1b")[2]

    def grad_fn(pn, b):
        """Each node's gradients through the compile the loss test
        shares, stacked."""
        per = [_jvalue_and_grad("gemma3-1b")(
            jax.tree.map(lambda x: x[i], pn), jax.tree.map(
                lambda x: x[i], b))[1] for i in range(N)]
        return jax.tree.map(lambda *g: jnp.stack(g), *per)
    method = jmake("dsgdm")
    sched = jbuild(JSpec("base", N, 1))
    pn = jax.tree.map(lambda p: jnp.broadcast_to(p[None], (N,) + p.shape)
                      + 0.0, jparams)
    state = method.init(pn)
    step = jax.jit(lambda p, g, s, W: method.step(p, g, s, W, ETA))
    batches = _batches("gemma3-1b", N, B, STEPS)
    for r in range(STEPS):
        b = jax.tree.map(jnp.asarray, batches[r])
        pn, state = step(pn, grad_fn(pn, b), state, jnp.asarray(sched.W(r)))
    want = tree_from_jax(jax.tree.map(np.asarray, pn), node_axis=True)
    nodes = _node_whole("gemma3-1b", MESH, ranks["methods"],
                        lambda r: r[("dsgdm", False)]["shards"][-1])
    for i, whole in enumerate(nodes):
        for k, v in want.items():
            assert err(whole[k], v[i]) <= 2e-4, (i, k)


def test_overlap_equals_sequential_bitwise(ranks):
    for r in ranks["methods"]:
        seq, ovl = r[("dsgdm", False)], r[("dsgdm", True)]
        assert seq["losses"] == ovl["losses"]
        assert seq["sent"] == ovl["sent"]
        for a, b in zip(seq["shards"], ovl["shards"]):
            for k in a:
                assert np.array_equal(a[k], b[k]), k


def test_gossip_moves_shards(ranks):
    """A rank sends its shards: fewer bytes than the one-model-rank
    step's rank, and a node's two model ranks together more (the
    replicated vectors go twice)."""
    per_rank = ranks["methods"]
    one = {r["node"]: r[("dsgdm", False, "one")]["sent"]["bytes"]
           for r in per_rank if not r["coords"]["model"]}
    for node, want in one.items():
        sent = [r[("dsgdm", False)]["sent"]["bytes"] for r in per_rank
                if r["node"] == node]
        assert all(want / 2 < s < want for s in sent), (sent, want)
        assert sum(sent) > want


# ---------------------------------------------------------------------------
# loss and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_loss_and_grads_match_reference(ranks, case):
    """Each node's step-0 loss and gradients, put back together from its
    ranks, within 1e-4 of ``jax.value_and_grad`` of the reference's
    ``loss_fn`` over the node's whole batch."""
    arch, layout, nodes, rows, seq, _, split = GRAD_CASES[case]
    per_rank = ranks[case]
    node_axis = "data" if nodes > 1 else "none"
    whole = _node_whole(arch, layout, per_rank, lambda r: r["grads"],
                        node_axis)
    batch = _batches(arch, nodes, rows, 1, seq)[0]
    jparams = pair(arch)[2]
    for r in per_rank:
        assert r["n_nodes"] == nodes and tuple(r["row_axes"]) == split
        assert r["backward"]["collectives"] > 0
    for i in range(nodes):
        (jloss, _), jgrads = _jvalue_and_grad(arch)(
            jparams, {k: jnp.asarray(v[i]) for k, v in batch.items()})
        for r in per_rank:
            if r["node"] == i:
                assert abs(r["loss"] - float(jloss)) <= 1e-4, case
                assert r["losses"][0] == r["loss"]
        want = tree_from_jax(jax.tree.map(np.asarray, jgrads))
        assert set(whole[i]) == set(want)
        for k, g in want.items():
            assert err(whole[i][k], g) <= 1e-4, (case, k)


def test_compressed_mixer_chunks_each_shard(ranks):
    """int8 + EF over the node axis: each model rank's mixed shards and
    residuals equal the reference's ``compressed_dense_mix`` of the
    nodes' shard trees (the reference's tensor-parallel chunking),
    mixed values within 1e-6 and residuals bit for bit."""
    params, ef = _compress_inputs()
    specs = _specs("gemma3-1b", MESH)
    mesh = _mesh(MESH)
    W = np.asarray(jbuild(JSpec("base", N, 1)).W(0), np.float32)
    from repro_torch.convert import shard_for_rank
    for m in range(2):
        coords = {"data": 0, "model": m}

        def shard_tree(tree):
            rows = [shard_for_rank({k: torch.from_numpy(v[i]) for k, v in
                                    tree.items()}, specs, mesh, coords)
                    for i in range(N)]
            return {k: torch.stack([row[k] for row in rows])
                    for k in rows[0]}
        jout, jef = compressed_dense_mix(
            jnp.asarray(W), jax.tree.map(jnp.asarray, tree_to_jax(
                shard_tree(params), node_axis=True)),
            jax.tree.map(jnp.asarray, tree_to_jax(shard_tree(ef),
                                                  node_axis=True)),
            JCompressionConfig(**INT8), 5)
        jout = tree_from_jax(jax.tree.map(np.asarray, jout), node_axis=True)
        jef = tree_from_jax(jax.tree.map(np.asarray, jef), node_axis=True)
        for r in ranks["compress"]:
            if r["coords"]["model"] != m:
                continue
            i = r["coords"]["data"]
            for k in jout:
                assert err(r["mixed"][k], jout[k][i]) <= 1e-6, k
                assert np.array_equal(r["ef"][k], jef[k][i]), k


def test_checkpoints_over_the_mesh_load_in_the_reference(ranks):
    """``--ckpt-dir --ckpt-every 1`` over (data 2, model 2): each rank
    writes its shards with the global slices they cover, and the
    reference's ``load_pytree`` reads "latest" (after the last step's
    save, both nodes' whole parameters) and the node-mean "ckpt" (each
    shard averaged over the nodes by node 0's ranks) bit for bit."""
    from repro.checkpoint import load_pytree as jload
    import repro.models.model as JM

    per_rank = ranks["ckpt"]
    assert all(r["saves"] == ["latest"] * (CKPT_STEPS - 1)
               for r in per_rank)
    nodes = _node_whole("gemma3-1b", MESH, per_rank, lambda r: r["shards"])
    jcfg = pair("gemma3-1b")[0]
    shapes = jax.eval_shape(lambda k: JM.init(jcfg, k, jnp.float32),
                            jax.random.PRNGKey(0))
    stacked = jax.tree.map(lambda s: jnp.zeros((N,) + s.shape, s.dtype),
                           shapes)
    latest = jload({"params": stacked, "opt": {"u": stacked},
                    "step": jnp.int32(0)}, ranks["ckpt_dir"], name="latest")
    assert int(latest["step"]) == CKPT_STEPS - 1
    got = tree_from_jax(jax.tree.map(np.asarray, latest["params"]),
                        node_axis=True)
    mean = tree_from_jax(jax.tree.map(np.asarray, jload(
        jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes),
        ranks["ckpt_dir"])))
    for k, v in got.items():
        for i in range(N):
            assert np.array_equal(v[i], nodes[i][k].numpy()), (i, k)
        want = (nodes[0][k].numpy() + nodes[1][k].numpy()) / np.float32(N)
        assert np.array_equal(mean[k], want), k


def _dry(arch, layout, rank, rows, seq, **kw):
    from repro_torch.launch.dryrun import dry_cell
    from repro_torch.launch.mesh import dry_mesh
    mesh = dry_mesh(_mesh(layout), rank)
    return mesh, dry_cell(pair(arch)[1], "train", mesh, batch=rows,
                          seq=seq, param_dtype=torch.float32, **kw)


@pytest.mark.parametrize("case", list(GRAD_CASES) + ["gemma-methods"])
def test_dry_run_gathers_equal_live_ranks(ranks, case):
    """``launch.dryrun.dry_cell`` of one train step's gradients on each
    rank's coordinates of a dry mesh (the meta device): the gathers and
    bytes, forward and backward, the live gloo ranks counted (the
    methods case: per step of its dsgdm run), and the gossip bytes its
    mixer sent a step."""
    if case == "gemma-methods":
        arch, layout, nodes, rows, seq, kw = \
            "gemma3-1b", MESH, N, B, SEQ, {}
        live = [dict(r[("dsgdm", False)], coords=r["coords"])
                for r in ranks["methods"]]
        steps = STEPS
    else:
        arch, layout, nodes, rows, seq, kw, _ = GRAD_CASES[case]
        live, steps = ranks[case], 1
        kw = {"embed_hint": True} if kw else {}
    for rank, r in enumerate(live):
        mesh, got = _dry(arch, layout, rank, nodes * rows, seq,
                         remat=False, **kw)
        assert mesh.coords == r["coords"]
        bwd = r["backward"]
        assert (steps * got["gathers"], steps * got["gather_bytes"]) == (
            r["gathers"]["collectives"], r["gathers"]["bytes"]), r["coords"]
        assert (steps * got["bwd_gathers"], steps * got["bwd_bytes"]) == (
            bwd["collectives"], bwd["bytes"]), r["coords"]
        if case == "gemma-methods":
            assert steps * got["gossip_bytes"] == r["sent"]["bytes"]


def _restored(ranks, directory, layout, coords, node_axis="data",
              nodes=True, name="latest"):
    """``name`` under ``directory`` restored onto the rank at ``coords``
    of ``layout`` (``load_pytree(placement=)``): its params, its
    momentum and the step."""
    from repro_torch.checkpoint import load_pytree
    from repro_torch.checkpoint.io import mesh_placement
    from repro_torch.dist.sharding import local_shape

    mesh = Mesh(dict(zip(layout[1], layout[0])), coords=coords)
    specs = _specs("gemma3-1b", layout)
    full = _full("gemma3-1b")
    lead = (1,) if nodes else ()
    row = {k: torch.zeros(lead + local_shape(v.shape, specs[k], mesh))
           for k, v in full.items()}
    tree = {"params": row, "opt": {"u": dict(row)}, "step": 0} if nodes \
        else row
    return load_pytree(tree, directory, name, placement=mesh_placement(
        specs, mesh, node_axis, nodes=nodes))


@pytest.mark.parametrize("case", ["2x2", "2x1", "one-rank", "2x1-to-2x2"])
def test_mesh_checkpoint_restores_onto_any_mesh(ranks, case):
    """``load_pytree(placement=)`` of the (data 2, model 2) run's
    "latest": onto (2, 2) each rank's shards, onto (2, 1) each node's
    row, onto one rank the whole leaves (and the node-mean "ckpt"
    whole); and the copy saved on (2, 1) by the ranks onto (2, 2): each
    bit for bit the trained tensors."""
    per_rank = ranks["ckpt"]
    d = ranks["ckpt_dir"]
    nodes = _node_whole("gemma3-1b", MESH, per_rank, lambda r: r["shards"])
    if case in ("2x2", "2x1-to-2x2"):
        src = d if case == "2x2" else f"{d}/narrow"
        if case != "2x2":
            assert [r["narrow_step"] for r in per_rank] == \
                [CKPT_STEPS - 1, None, CKPT_STEPS - 1, None]
        for r in per_rank:
            got = _restored(ranks, src, MESH, r["coords"])
            assert got["step"] == CKPT_STEPS - 1
            assert got["params"].keys() == r["shards"].keys()
            for k, v in r["shards"].items():
                assert np.array_equal(got["params"][k][0].numpy(), v), k
    elif case == "2x1":
        for i in range(N):
            got = _restored(ranks, d, ((2, 1), ("data", "model")),
                            {"data": i, "model": 0})
            for k, v in nodes[i].items():
                assert torch.equal(got["params"][k][0], v), (i, k)
    else:
        from repro_torch.checkpoint import load_pytree
        whole = {k: torch.zeros((N,) + v.shape)
                 for k, v in _full("gemma3-1b").items()}
        got = load_pytree({"params": whole, "opt": {"u": dict(whole)},
                           "step": 0}, d, "latest", node_axis=True)
        mean = _restored(ranks, d, ((1, 1), ("data", "model")),
                         {"data": 0, "model": 0}, node_axis=None,
                         nodes=False, name="ckpt")
        for k in whole:
            want = torch.stack([nodes[i][k] for i in range(N)])
            assert torch.equal(got["params"][k], want), k
            assert torch.equal(mean[k], (want[0] + want[1]) / N), k


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _printed(out):
    """``(step, mean loss, nodes)`` of each of the launcher's mean
    lines."""
    return [(int(m[1]), float(m[2]), int(m[3])) for m in re.finditer(
        r"^step +(\d+) +loss (\S+) +\(mean over (\d+) nodes\)", out,
        re.M)]


@pytest.fixture(scope="module")
def one_model_rank_run():
    """``--nproc 2``: two ranks, one node each."""
    opts = T.TrainOptions(arch="gemma3-1b", reduced=True, steps=3,
                          batch=4, seq=16, log_every=1, remat=False)
    return T.launch(opts, nproc=2, device="cpu")


@pytest.mark.parametrize("data,model,layout", [
    (None, 2, ((2, 2), ("data", "model"))),
    (4, 1, ((4, 1), ("data", "model"))),
    (1, 4, ((1, 4), ("data", "model"))),
    (None, 1, None)])
def test_launcher_mesh_layout(data, model, layout):
    """The mesh ``--mesh-data`` / ``--mesh-model`` lay 4 ranks out as
    (None: one node per rank, the step over a group)."""
    opts = T.TrainOptions(mesh_data=data, mesh_model=model)
    assert T.mesh_layout(opts, 4) == layout


def test_launcher_mesh_matches_nproc_2(one_model_rank_run, capsys,
                                       monkeypatch):
    """``--nproc 4 --mesh-data 2 --mesh-model 2``: each rank's node
    losses within 1e-5 of ``--nproc 2``'s, and the printed mean over the
    2 nodes (each counted once) equal to its to the 4 places printed."""
    flags = ["--mesh-data", "2", "--mesh-model", "2"]
    runs = []
    launch = T.launch

    def recording(*args, **kw):
        runs.append(launch(*args, **kw))
        return runs[-1]

    monkeypatch.setattr(T, "launch", recording)
    T.main(LAUNCH + ["--nproc", "4", *flags])
    printed = _printed(capsys.readouterr().out)
    (got,) = runs
    assert [r["node"] for r in got] == [0, 0, 1, 1]
    assert [r["lead"] for r in got] == [True, False, True, False]
    for r in got:
        want = one_model_rank_run[r["node"]]["losses"]
        assert np.max(np.abs(np.subtract(r["losses"], want))) <= 1e-5
    want = np.mean([r["losses"] for r in one_model_rank_run], axis=0)
    assert [(s, n) for s, _, n in printed] == [(0, 2), (1, 2), (2, 2)]
    for s, loss, _ in printed:
        assert abs(loss - want[s]) <= 5e-5 + 1e-5


def test_production_mesh_needs_its_ranks():
    with pytest.raises(ValueError, match="256 ranks"):
        T.main(LAUNCH + ["--nproc", "4", "--production-mesh", "single"])
    with pytest.raises(ValueError, match="512 ranks"):
        T.main(LAUNCH + ["--nproc", "4", "--production-mesh", "multi"])
    with pytest.raises(ValueError, match="needs 6 ranks"):
        T.main(LAUNCH + ["--nproc", "4", "--mesh-data", "3",
                         "--mesh-model", "2"])
