"""The dry run on the meta device (``repro_torch.launch.dryrun``; no
JAX: the reference compiles XLA programs, which the port has no
counterpart of, so its numbers are held to the port's own live ranks).

* full-width gemma3-1b on a (data 2, model 2) dry mesh at the card's
  tensor-parallel shapes (``chip_smoke.py``'s ``[tp-serve]`` /
  ``[tp-train]``: B = 4 prompts of 1024 and 32 new tokens, one row of
  1024 a node, remat): every rank's gathers and bytes, and the gossip
  bytes, equal what those phases counted on the card's gloo ranks
  (184 a decode step; 537 a train step, 353 forward of 1,979,318,272
  bytes and 184 backward of 730,464,256; 2,000,040,448 sent);
* one production cell per family, rank 0 of the 16 x 16 mesh, ends with
  ``status: ok``, and the parameter bytes it reports are the table's
  share (``dist.tp.shard_bytes``);
* the sweep's CLI writes one JSON per cell, skips existing ones, and a
  cell that cannot run ends with ``status: error`` and its traceback;
* ``DryCollectives`` and the meta attention shapes.

The reduced archs' gathers against the live ranks of
``tests/torch_tp_ranks.py`` / ``torch_tp_train_ranks.py`` are held in
``tests/test_torch_tp_serve.py`` / ``test_torch_tp_train.py``, on those
modules' one spawn each.
"""
import json

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dist.tp import DryCollectives, shard_bytes
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import (DryGroup, Mesh, dry_mesh,
                                     make_production_mesh)

MESH = Mesh({"data": 2, "model": 2})
PROMPT, NEW = 1024, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("rank", range(4))
def test_full_width_tp_counts_equal_the_cards(rank):
    cfg = get_config("gemma3-1b")
    mesh = dry_mesh(MESH, rank)
    dec = D.dry_cell(cfg, "decode", mesh, batch=4, seq=PROMPT + NEW)
    assert (dec["gathers"], dec["bwd_gathers"]) == (184, 0)
    assert dec["rows"] == 2 and dec["memory"]["params"] == shard_bytes(
        cfg, torch.bfloat16, MESH)
    tr = D.dry_cell(cfg, "train", mesh, batch=2, seq=PROMPT)
    assert (tr["gathers"], tr["gather_bytes"]) == (537, 2709782528)
    assert (tr["bwd_gathers"], tr["bwd_bytes"]) == (184, 730464256)
    assert tr["gather_bytes"] - tr["bwd_bytes"] == 1979318272
    assert tr["gossip_bytes"] == 2000040448
    assert (tr["n_nodes"], tr["node"]) == (2, mesh.coords["data"])


FAMILY_CELLS = [("gemma3-1b", "train_4k"), ("grok-1-314b", "decode_32k"),
                ("mamba2-2.7b", "long_500k"),
                ("jamba-1.5-large-398b", "long_500k"),
                ("llava-next-34b", "decode_32k"),
                ("seamless-m4t-large-v2", "decode_32k")]


@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_production_cell_per_family_ok(arch, shape):
    res = D.dryrun_one(arch, shape, multi_pod=False)
    assert res["status"] == "ok", res
    mesh = make_production_mesh()
    assert res["ranks"] == 256
    cfg = get_config(arch)
    if shape == "train_4k":
        assert res["n_nodes"] == 16 and res["gossip_bytes"] > 0
        assert res["memory"]["opt_state"] == res["memory"]["params"]
    else:
        assert res["memory"]["params"] == shard_bytes(
            cfg.long_context_variant() if shape == "long_500k" else cfg,
            torch.bfloat16, mesh)
        assert res["memory"]["cache"] > 0
    assert res["gathers"] > 0 and res["flops_per_rank"] > 0
    assert res["compute_s"] == pytest.approx(
        res["flops_per_rank"] / 989e12, rel=1e-12)
    assert res["fits"] == (res["memory"]["total"] <= 80e9)


def test_sweep_cli_writes_skips_and_reports_errors(tmp_path, monkeypatch):
    args = ["--arch", "granite-8b", "--mesh", "single", "--out",
            str(tmp_path)]
    real = D.dryrun_one

    def broken(arch, shape, **kw):
        if shape == "prefill_32k":
            raise RuntimeError("cannot run on meta")
        if shape == "train_4k":       # the slow cells are not the point
            return {"arch": arch, "shape": shape, "status": "ok"}
        return real(arch, shape, **kw)

    monkeypatch.setattr(D, "dryrun_one", broken)
    D.main(args + ["--shape", "prefill_32k"])
    err = json.loads((tmp_path / "granite-8b_prefill_32k_single.json")
                     .read_text())
    assert err["status"] == "error"
    assert "cannot run on meta" in err["traceback"]
    D.main(args)
    got = {p.name: json.loads(p.read_text())["status"]
           for p in tmp_path.iterdir()}
    assert got == {"granite-8b_train_4k_single.json": "ok",
                   "granite-8b_prefill_32k_single.json": "error",
                   "granite-8b_decode_32k_single.json": "ok",
                   "granite-8b_long_500k_single.json": "skipped"}


def test_dry_collectives_count_as_live_and_send_nothing():
    comm = DryCollectives(dry_mesh(MESH, 3))
    t = torch.empty(2, 5, dtype=torch.bfloat16, device="meta")
    pieces = comm.gather(t, "model")
    assert len(pieces) == 2 and pieces[1] is t
    assert pieces[0].shape == t.shape and pieces[0].device.type == "meta"
    assert comm.stats == {"collectives": 1, "bytes": 20}
    y = comm.cat(t.requires_grad_(), "data", -1)
    assert y.shape == (2, 10)
    assert comm.stats == {"collectives": 2, "bytes": 40}
    with pytest.raises(ValueError, match="meta tensors only"):
        comm.gather(torch.zeros(2, 5), "model")
    with pytest.raises(ValueError, match="live mesh"):
        DryCollectives(MESH)
    mesh = dry_mesh(MESH, 2)
    assert mesh.dry and mesh.group("data") == DryGroup(2, 1)
    # coordinates without groups are not a dry mesh: its gathers raise
    # (they would be uninitialised memory), and so does its group
    placed = Mesh(MESH.shape, mesh.coords)
    assert not placed.dry
    with pytest.raises(ValueError, match="no process groups"):
        placed.group("data")


def test_meta_attention_is_a_shape_function():
    q = torch.empty(2, 3, 8, 64, device="meta", requires_grad=True)
    k = torch.empty(2, 16, 2, 64, device="meta", requires_grad=True)
    v = torch.empty(2, 16, 2, 32, device="meta", requires_grad=True)
    out = ops.sdpa(q, k, v)
    assert out.shape == (2, 3, 8, 32) and out.device.type == "meta"
    dq, dk, dv = torch.autograd.grad(out.sum(), (q, k, v))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    with torch.no_grad():
        got = ops.sdpa_decode(q, k, v, q_start=4, k_valid_len=8)
    assert got.shape == (2, 3, 8, 32)
    with pytest.raises(ValueError, match="H % KV"):
        ops.sdpa(q, torch.empty(2, 16, 3, 64, device="meta"), v)
