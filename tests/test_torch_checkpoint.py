"""The port's checkpoints (``repro_torch.checkpoint``, format v2) against
the reference's (``repro.checkpoint``), on the CPU.

- In one process: round trips of the paper MLP, of a flat dict of mixed
  dtypes (f32, f16, bf16, int32, bool, a 0-d tensor, an int step) and of
  DSGD-momentum's and int8 + EF's node-stacked states (``ct`` an int),
  bit for bit; bf16 is stored as uint16 with ``stored_dtype`` bfloat16.
  The reference's four crash-consistency cases
  (``tests/test_checkpoint_resharding.py``): ``manifest.json`` is written
  last, a severed write leaves nothing loadable, a stray staging
  directory is not loadable, a missing shard file is detected, and a
  second save under a name swaps in.  A save followed at once by an
  in-place change of every saved tensor loads the values of the save.
- Across packages: the reference's ``save_pytree`` of node-stacked (3,
  ...) reduced gemma3-1b (2 pattern blocks, bf16) with its DSGD-momentum
  state loads into the port bit for bit, into each rank's (1, ...) slice
  and into the simulation's (3, ...) tensors.  Three gloo ranks of the
  port (spawned once for the module) write ``latest``, one shard file
  each, and the reference's ``load_pytree`` reads it bit for bit; rank
  0's node-mean ``ckpt`` is within one bf16 ulp of ``jnp.mean`` of the
  same stack (the count of elements that differ is printed).
- Resume: the launcher's 4 steps with a save after step 2, and a run
  resumed from it through a new step bundle, equal bit for bit, for
  DSGD-momentum and for int8 + EF (``ct`` and ``ef`` restored).
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_ckpt_ranks
from repro.checkpoint import load_pytree as jload
from repro.checkpoint import save_pytree as jsave
from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro_torch.checkpoint import AsyncCheckpointer, load_pytree, \
    save_pytree
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.compress import CompressionConfig
from repro_torch.convert import rank_slice, tree_from_jax, tree_to_jax
from repro_torch.launch import distributed as D
from repro_torch.launch.train import TrainOptions
from repro_torch.models import mlp
from repro_torch.optim.decentralized import make_method

N, BLOCKS, STEP = 3, 2, 2**25 + 1
BF16 = np.dtype(ml_dtypes.bfloat16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    return t.reshape(-1).view(torch.uint8).numpy()


def _same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(_bits(got), _bits(want))
    else:
        assert type(got) is type(want) and got == want


def _mixed_tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn(3, 4, generator=g),
            "b": torch.randn(5, generator=g).half(),
            "c": torch.randn(2, 7, generator=g).bfloat16(),
            "d": torch.randint(-2**31, 2**31 - 1, (4,), generator=g,
                               dtype=torch.int32),
            "e": torch.rand(3, generator=g) > 0.5,
            "f": torch.tensor(1.5),
            "step": STEP}


def _node_tree(method, compression=None):
    """Node-stacked params with two pattern blocks, and the method's state
    of random values (int8 + EF: ``ct`` = 5 and f32 residuals)."""
    g = torch.Generator().manual_seed(1)
    params = {"embed.table": torch.randn(N, 6, 4, generator=g),
              "stack.blocks.0.0.w": torch.randn(N, 4, 4, generator=g),
              "stack.blocks.1.0.w": torch.randn(N, 4, 4, generator=g),
              "final_norm.scale": torch.randn(N, 4, generator=g)}
    state = make_method(method, compression=compression).init(params)
    for sk, sv in state.items():
        if isinstance(sv, dict):
            state[sk] = {k: torch.randn(v.shape, generator=g)
                         for k, v in sv.items()}
    if "ct" in state:
        state["ct"] = 5
    return {"params": params, "opt": state, "step": 3}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return type(tree)(0)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def test_roundtrip_paper_mlp(tmp_path):
    params = mlp.init(mlp.MLPConfig(), seed=0, device="cpu")
    save_pytree(params, str(tmp_path), name="mlp")
    _same(load_pytree(_zeros_like(params), str(tmp_path), "mlp"), params)


def test_roundtrip_mixed_dtypes_and_bf16_bits(tmp_path):
    tree = _mixed_tree()
    save_pytree(tree, str(tmp_path))
    _same(load_pytree(_zeros_like(tree), str(tmp_path)), tree)
    with open(tmp_path / "ckpt" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert leaves["c"]["dtype"] == "bfloat16"
    assert leaves["c"]["shards"][0]["stored_dtype"] == "bfloat16"
    assert leaves["step"] == {"shape": [], "dtype": "int32", "shards": [
        {"file": "shards-p0.npz", "entry": "step::0", "index": [],
         "stored_dtype": None}]}
    with np.load(tmp_path / "ckpt" / "shards-p0.npz") as z:
        assert z["c::0"].dtype == np.uint16
        assert np.array_equal(z["c::0"], tree["c"].view(torch.int16)
                              .numpy().view(np.uint16))


@pytest.mark.parametrize("method,compression", [
    ("dsgdm", None),
    ("dsgdm", CompressionConfig(codec="int8", chunk=64,
                                error_feedback=True))], ids=["dsgdm", "int8"])
def test_roundtrip_method_state(tmp_path, method, compression):
    tree = _node_tree(method, compression)
    save_pytree(tree, str(tmp_path), node_axis=True)
    got = load_pytree(_zeros_like(tree), str(tmp_path), node_axis=True)
    _same(got, tree)
    for r in range(N):      # and each rank's slice of it
        _same(load_pytree(_zeros_like(rank_slice(tree, r)), str(tmp_path),
                          rank=r), rank_slice(tree, r))


def test_manifest_is_written_last(tmp_path, monkeypatch):
    order = []
    real = ckpt_io._write_manifest

    def spying(tmp_dir, fname, manifest):
        if fname == "manifest.json":
            assert os.path.exists(os.path.join(tmp_dir, "shards-p0.npz"))
            assert os.path.exists(os.path.join(tmp_dir, "manifest-p0.json"))
        order.append(fname)
        real(tmp_dir, fname, manifest)

    monkeypatch.setattr(ckpt_io, "_write_manifest", spying)
    save_pytree(_mixed_tree(), str(tmp_path), name="c")
    assert order[-1] == "manifest.json"


def test_crash_before_commit_leaves_no_loadable_checkpoint(tmp_path,
                                                           monkeypatch):
    def boom(tmp_dir, fname, manifest):
        raise OSError("simulated crash mid-write")

    monkeypatch.setattr(ckpt_io, "_write_manifest", boom)
    ckpt = AsyncCheckpointer(str(tmp_path))
    fut = ckpt.save(_mixed_tree(), name="crashed")
    with pytest.raises(OSError, match="simulated crash"):
        fut.result(timeout=60)
    with pytest.raises(OSError, match="simulated crash"):
        ckpt.wait()
    ckpt.close()
    assert os.listdir(tmp_path) == []
    with pytest.raises(FileNotFoundError):
        load_pytree(_mixed_tree(), str(tmp_path), name="crashed")


def test_stray_staging_dir_is_not_loadable(tmp_path):
    stray = tmp_path / ".tmp-ckpt-deadbeef-0"
    stray.mkdir()
    (stray / "shards-p0.npz").write_bytes(b"partial")
    with pytest.raises(FileNotFoundError):
        load_pytree(_mixed_tree(), str(tmp_path), name="ckpt")


def test_missing_shard_file_is_detected(tmp_path):
    tree = _node_tree("dsgdm")
    save_pytree(tree, str(tmp_path), name="gap", node_axis=True)
    os.remove(tmp_path / "gap" / "shards-p0.npz")
    with pytest.raises((FileNotFoundError, ValueError)):
        load_pytree(_zeros_like(tree), str(tmp_path), name="gap",
                    node_axis=True)
    # a rank whose shard file is gone: the shards no longer cover its rows
    save_pytree(tree, str(tmp_path), name="cut", node_axis=True)
    with open(tmp_path / "cut" / "manifest.json") as f:
        manifest = json.load(f)
    for rec in manifest["leaves"].values():
        for s in rec["shards"]:
            if s["index"]:
                s["index"][0] = [0, N - 1]
    (tmp_path / "cut" / "manifest.json").write_text(json.dumps(manifest))
    (tmp_path / "cut" / "manifest-p0.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="do not cover"):
        load_pytree(_zeros_like(rank_slice(tree, N - 1)), str(tmp_path),
                    name="cut", rank=N - 1)


def test_resave_same_name_swaps_atomically(tmp_path):
    save_pytree({"w": torch.zeros(2)}, str(tmp_path), name="latest")
    save_pytree({"w": torch.ones(2)}, str(tmp_path), name="latest")
    out = load_pytree({"w": torch.zeros(2)}, str(tmp_path), name="latest")
    assert float(out["w"][0]) == 1.0
    assert not [d for d in os.listdir(tmp_path) if ".old-" in d]


def test_snapshot_holds_against_inplace_updates(tmp_path):
    """Every saved tensor changed in place right after ``save()`` returns
    (as the EF21 residuals are): the checkpoint holds the saved values;
    and ``wait()`` drains several saves."""
    tree = _node_tree("dsgdm", CompressionConfig(codec="int8", chunk=64,
                                                 error_feedback=True))
    want = {"params": {k: v.clone() for k, v in tree["params"].items()},
            "opt": {k: ({kk: vv.clone() for kk, vv in v.items()}
                        if isinstance(v, dict) else v)
                    for k, v in tree["opt"].items()}, "step": 3}
    ckpt = AsyncCheckpointer(str(tmp_path))
    for i in range(3):
        ckpt.save(tree, name=f"s{i}", node_axis=True)
        for t in [*tree["params"].values(), *tree["opt"]["u"].values(),
                  *tree["opt"]["ef"].values()]:
            t.add_(1.0)
    ckpt.close()
    assert [r["name"] for r in ckpt.stats] == ["s0", "s1", "s2"]
    assert all(r["bytes"] > 0 and r["write_s"] >= 0 for r in ckpt.stats)
    for i in range(3):
        got = load_pytree(_zeros_like(tree), str(tmp_path), f"s{i}",
                          node_axis=True)
        _same(got, want)
        want = {"params": {k: v + 1.0 for k, v in want["params"].items()},
                "opt": {k: ({kk: vv + 1.0 for kk, vv in v.items()}
                            if isinstance(v, dict) else v)
                        for k, v in want["opt"].items()}, "step": 3}


def test_snapshot_buffers_are_reused_and_bounded(tmp_path, monkeypatch):
    """A save after the writer has handed its buffer back takes that
    buffer; while the writer holds both of the checkpointer's buffers, a
    third save waits for one; every checkpoint holds its own values."""
    import threading

    tree = _node_tree("dsgdm")
    ckpt = AsyncCheckpointer(str(tmp_path))
    ckpt.save(tree, name="first", node_axis=True)
    ckpt.wait()
    ckpt.save(tree, name="again", node_axis=True)
    ckpt.wait()
    assert [r["new_buffer"] for r in ckpt.stats] == [True, False]

    gate, real = threading.Event(), ckpt_io._write_shard_file

    def held(tmp_dir, proc, payload):
        gate.wait(60)
        real(tmp_dir, proc, payload)

    monkeypatch.setattr(ckpt_io, "_write_shard_file", held)
    wants = []
    for i in range(2):
        ckpt.save(tree, name=f"held{i}", node_axis=True)
        wants.append(tree["params"]["embed.table"].clone())
        tree["params"]["embed.table"].add_(1.0)
    third = threading.Thread(
        target=ckpt.save, args=(tree,), kwargs={"name": "held2",
                                                "node_axis": True})
    third.start()
    third.join(0.3)
    assert third.is_alive(), "a third save did not wait for a buffer"
    gate.set()
    third.join(60)
    wants.append(tree["params"]["embed.table"].clone())
    ckpt.close()
    assert [r["new_buffer"] for r in ckpt.stats[2:]] == [False, True, False]
    for i, want in enumerate(wants):
        got = load_pytree(_zeros_like(tree), str(tmp_path), f"held{i}",
                          node_axis=True)
        assert torch.equal(got["params"]["embed.table"], want)


def test_tree_to_jax_inverts_tree_from_jax():
    tree = _node_tree("dsgdm")["params"]
    back = tree_to_jax(tree, node_axis=True)
    assert back["stack"]["blocks"][0]["w"].shape == (N, 2, 4, 4)
    _same(tree_from_jax(back, node_axis=True), tree)
    bf = {k: v.bfloat16() for k, v in tree.items()}
    jtree = jax.tree.map(lambda a: a.view(BF16),
                         tree_to_jax(bf, node_axis=True))
    got = tree_from_jax(jtree, node_axis=True)
    _same(got, bf)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def _jcfg():
    return jget_config("gemma3-1b").reduced(num_blocks=BLOCKS)


@pytest.fixture(scope="module")
def ref_stack():
    """Reduced gemma3-1b with 2 pattern blocks, node-stacked to (3, ...)
    in bf16 from numpy draws, and a DSGD-momentum state alike."""
    rng = np.random.default_rng(7)
    shapes = jax.eval_shape(lambda k: JM.init(_jcfg(), k, jnp.bfloat16),
                            jax.random.PRNGKey(0))

    def draw(s):
        return (0.5 * rng.standard_normal((N,) + s.shape)).astype(BF16)

    return {"params": jax.tree.map(draw, shapes),
            "opt": {"u": jax.tree.map(draw, shapes)}}


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory, ref_stack):
    d = str(tmp_path_factory.mktemp("ref"))
    jsave({**ref_stack, "step": jnp.int32(STEP)}, d, name="latest")
    return d


def _port_stack(ref_stack):
    return {"params": tree_from_jax(ref_stack["params"], node_axis=True),
            "opt": {"u": tree_from_jax(ref_stack["opt"]["u"],
                                       node_axis=True)}, "step": STEP}


@pytest.mark.parametrize("rank", [0, 1, 2, None],
                         ids=["rank0", "rank1", "rank2", "simulation"])
def test_reference_checkpoint_loads_into_the_port(ref_stack, ref_dir, rank):
    want = _port_stack(ref_stack)
    if rank is not None:
        want = rank_slice(want, rank)
    got = load_pytree(_zeros_like(want), ref_dir, "latest", rank=rank,
                      node_axis=True)
    _same(got, want)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ref_stack):
    """Three gloo ranks: each writes its slice of ``ref_stack`` under
    "latest" and the node-mean under "ckpt"; then the launcher's resume
    cases."""
    d = str(tmp_path_factory.mktemp("port"))
    flat = _port_stack(ref_stack)

    def bits(tree):
        return {k: v.view(torch.int16).numpy().view(np.uint16)
                for k, v in tree.items()}

    resume = []
    for name, compress in (("dsgdm", None),
                           ("int8", CompressionConfig(
                               codec="int8", chunk=256, error_feedback=True,
                               seed=0).to_json())):
        resume.append((name, TrainOptions(
            arch="gemma3-1b", reduced=True, steps=4, batch=6, seq=16,
            log_every=4, remat=False, compress=compress,
            ckpt_dir=str(tmp_path_factory.mktemp(f"resume-{name}")),
            ckpt_every=2)))
    per_rank = D.spawn_local(
        torch_ckpt_ranks.checkpoint_cases, N, device="cpu", timeout=300,
        args=([d], bits(flat["params"]), bits(flat["opt"]["u"]), STEP,
              resume))
    return d, per_rank, dict(resume)


def test_port_ranks_checkpoint_loads_in_the_reference(ref_stack, ranks):
    d, per_rank, _ = ranks
    template = {**jax.tree.map(jnp.zeros_like, ref_stack),
                "step": jnp.int32(0)}
    got = jload(template, d, name="latest")
    assert int(got["step"]) == STEP
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(
            {**ref_stack, "step": np.int32(STEP)})):
        a, b = np.atleast_1d(a), np.atleast_1d(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_port_ranks_write_one_shard_file_each(ref_stack, ranks):
    d, per_rank, _ = ranks
    files = sorted(os.listdir(os.path.join(d, "latest")))
    assert files == ["manifest-p0.json", "manifest-p1.json",
                     "manifest-p2.json", "manifest.json", "shards-p0.npz",
                     "shards-p1.npz", "shards-p2.npz"]
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.shape(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                {**ref_stack, "step": np.int32(0)})[0]}
    for r in range(N):
        with open(os.path.join(d, "latest", f"manifest-p{r}.json")) as f:
            m = json.load(f)
        assert m["format_version"] == 2 and m["process_index"] == r
        assert m["process_count"] == N and m["name"] == "latest"
        assert {k: tuple(v["shape"]) for k, v in m["leaves"].items()} == want
        rec = m["leaves"]["params/stack/blocks/0/attn/wq/w"]
        assert rec["dtype"] == "bfloat16"
        assert rec["shards"] == [{
            "file": f"shards-p{r}.npz",
            "entry": "params/stack/blocks/0/attn/wq/w::0",
            "index": [[r, r + 1]] + [[0, n] for n in rec["shape"][1:]],
            "stored_dtype": "bfloat16"}]
    assert all(s[0]["bytes"] > 0 for s in per_rank[0:1] for s in [s["write"]])


def test_node_mean_ckpt_within_one_bf16_ulp(ref_stack, ranks, capsys):
    d = ranks[0]
    params = ref_stack["params"]
    template = jax.tree.map(lambda a: jnp.zeros(a.shape[1:], a.dtype),
                            params)
    got = jload(template, d, name="ckpt")
    differ = total = 0
    for a, x in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        want = np.asarray(jnp.mean(jnp.asarray(x), axis=0))
        a = np.asarray(a)
        assert a.dtype == want.dtype == BF16
        ulps = np.abs(a.view(np.uint16).astype(np.int64)
                      - want.view(np.uint16).astype(np.int64))
        assert int(ulps.max()) <= 1
        differ += int((ulps > 0).sum())
        total += a.size
    with capsys.disabled():
        print(f"\n[node-mean] {differ} of {total} elements differ from "
              f"jnp.mean by one bf16 ulp")


@pytest.mark.parametrize("name", ["dsgdm", "int8"])
def test_resume_equals_uninterrupted(ranks, name):
    _, per_rank, opts = ranks
    for res in per_rank:
        res = res[name]
        assert res["step"] == 2 and [s["name"] for s in res["saves"]] \
            == ["latest"]
        a, b = res["resumed"], res["uninterrupted"]
        for k in b["params"]:
            assert np.array_equal(a["params"][k].view(np.uint8),
                                  b["params"][k].view(np.uint8)), k
        assert a["state"].keys() == b["state"].keys()
        for sk, sv in b["state"].items():
            if isinstance(sv, dict):
                for k in sv:
                    assert np.array_equal(a["state"][sk][k].view(np.uint8),
                                          sv[k].view(np.uint8)), (sk, k)
            else:
                assert a["state"][sk] == sv
        assert a["losses"] == b["losses"][3:]
        if name == "int8":
            assert res["loaded_ct"] == 3 and b["state"]["ct"] == 4
            assert "ef" in b["state"]
    assert os.path.isdir(os.path.join(opts[name].ckpt_dir, "ckpt"))
