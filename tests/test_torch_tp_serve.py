"""Tensor-parallel serving (``repro_torch.dist.steps.make_prefill`` /
``make_decode_step``, ``serve.make_engine(mesh=)``, the serve launcher's
``--nproc`` / ``--mesh-model``) on four gloo CPU ranks as a (data 2,
model 2) mesh, against the reference.

One spawn for the module (``launch.distributed.spawn_local``, one
thread per rank) serves four reduced archs, each with the reference's
weights (``tests/torch_moe_cases.pair``) cut per rank by
``convert.shard_for_rank`` under the serve rules:

* gemma3-1b: the 1-D rule (every matrix's last dim on "model", the batch
  on "data"), the tied head's partial logits added over "model";
* grok-1-314b: the 2-D rule (contraction dims on "data" too, the batch
  whole on every rank), the experts gathered whole at their use;
* mamba2-2.7b: a Mamba layer's ``conv_w`` gathered whole;
* seamless-m4t-large-v2: the encoder over stub frames and the
  5-argument decode step.

Checks: prefill and two decode steps' logits of each rank's rows within
1e-4 of the reference's unsharded ``M.prefill`` / ``M.decode_step``
(f32 sums in another order; the reference's own sharded serving test
fails under jax 0.9, ROADMAP queue 3); the greedy tokens of
``make_engine(mesh=)`` equal the port's one-rank engine's (and, for
gemma3-1b, self-speculative k = 2 too, and k = 2 through a 1-block
draft model, its ``SpecStats`` as well); the shards put back together
equal the full dict bit for bit; one decode step gathers once per
sharded ``Dense`` and once for the embedding and once for the tied head.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks
from torch_moe_cases import MODEL_TOL, REF, _jprefill, err, pair, stubs
from repro.models import model as JM
from repro_torch.convert import unshard_ranks
from repro_torch.dist.sharding import (local_shape, make_rules,
                                       param_partition_specs)
from repro_torch.launch.distributed import spawn_local
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M
from repro_torch.models.layers import Dense
from repro_torch.serve import make_engine

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("gemma3-1b", "grok-1-314b", "mamba2-2.7b", "seamless-m4t-large-v2")
MESH = Mesh({"data": 2, "model": 2})
B, P, STEPS, NEW, SPEC_K = 4, 8, 2, 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(arch):
    """The whole batch (numpy) and the tokens the decode steps take."""
    cfg = pair(arch)[1]
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (B, P + STEPS))
    batch = {"tokens": tokens[:, :P], **stubs(cfg, B, 16, 8)}
    return batch, tokens[:, P:]


def _draft():
    """A 1-block draft model of reduced gemma3-1b (as ``[spec]``'s of the
    full width), its weights the port's draw from seed 5."""
    dcfg = dataclasses.replace(pair("gemma3-1b")[1], num_blocks=1)
    return dcfg, M.init(dcfg, seed=5, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def served():
    cases = []
    for arch in ARCHS:
        full = {k: v.numpy() for k, v in pair(arch)[3].state_dict().items()}
        batch, forced = _inputs(arch)
        draft = None
        if arch == "gemma3-1b":
            draft = {k: v.numpy()
                     for k, v in _draft()[1].state_dict().items()}
        cases.append((arch, full, batch, forced, NEW,
                      SPEC_K if arch == "gemma3-1b" else 0, draft))
    ranks = spawn_local(torch_tp_ranks.serve_cases, 4,
                        args=(cases, MESH.shape["model"]), backend="gloo",
                        device="cpu", timeout=240)
    return {arch: [r[i] for r in ranks] for i, arch in enumerate(ARCHS)}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_logits_match_reference(served, arch):
    jcfg, cfg, jparams, _ = pair(arch)
    batch, forced = _inputs(arch)
    seq = P + STEPS + 1
    jl, jc, jenc = _jprefill(arch, seq)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = [np.asarray(jl)]
    jdecode = jax.jit(lambda p, c, t, i, e: JM.decode_step(
        jcfg, p, c, t, i, e, kernel_config=REF))
    for i in range(STEPS):
        jl, jc = jdecode(jparams, jc, jnp.asarray(forced[:, i:i + 1]),
                         jnp.int32(P + i), jenc)
        want.append(np.asarray(jl))
    for r in served[arch]:
        rows = slice(r["row0"], r["row0"] + r["rows"])
        assert r["prefill"].shape == (r["rows"], 1, cfg.vocab_size)
        assert err(r["prefill"], want[0][rows]) <= MODEL_TOL, r["coords"]
        for i, got in enumerate(r["decode"]):
            assert err(got, want[i + 1][rows]) <= MODEL_TOL, (r["coords"], i)
        assert (r["enc"] is None) == (jenc is None)
        if jenc is not None:
            assert err(r["enc"], np.asarray(jenc)[rows]) <= MODEL_TOL
        assert r["decode_mode"] == "dus"
    # the 1-D rule splits the batch over "data"; the 2-D rule keeps it
    # whole on every rank
    two_d = arch == "grok-1-314b"
    assert [(r["row0"], r["rows"]) for r in served[arch]] == (
        [(0, B)] * 4 if two_d else [(0, 2), (0, 2), (2, 2), (2, 2)])
    assert all(tuple(r["dp"]) == (() if two_d else ("data",))
               for r in served[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_tokens_equal_one_rank_engine(served, arch):
    cfg, tparams = pair(arch)[1], pair(arch)[3]
    batch, _ = _inputs(arch)
    npfx = 16 if "prefix_embeds" in batch else 0
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in (0, SPEC_K) if arch == "gemma3-1b" else (0,):
        one = make_engine(cfg, batch=B, prompt_len=P, max_new=NEW,
                          prefix_len=npfx, param_dtype=torch.float32,
                          cache_dtype=torch.float32, speculate_k=k,
                          device="cpu")
        want = one.generate_with_state(tparams, tb).tokens.numpy()
        for r in served[arch]:
            got = r["tokens"][k]
            np.testing.assert_array_equal(
                got, want[r["row0"]:r["row0"] + r["rows"]],
                err_msg=f"k={k} {r['coords']}")
    assert set(served[arch][0]["tokens"]) == (
        {0, SPEC_K, "draft"} if arch == "gemma3-1b" else {0})


@pytest.mark.parametrize("arch", ARCHS)
def test_shards_reassemble_bit_for_bit(served, arch):
    cfg, tparams = pair(arch)[1], pair(arch)[3]
    full = tparams.state_dict()
    specs = param_partition_specs(full, make_rules(
        MESH, arch_name=arch, context="serve"))
    back = unshard_ranks([{k: torch.from_numpy(v)
                           for k, v in r["shards"].items()}
                          for r in served[arch]], specs, MESH)
    assert back.keys() == full.keys()
    for k, v in full.items():
        assert torch.equal(back[k], v), k
    # each shard has the table's shape: a sharded dim halved
    assert any(a for s in specs.values() for a in s)
    for r in served[arch]:
        for k, v in r["shards"].items():
            assert v.shape == local_shape(full[k].shape, specs[k], MESH), k


def test_one_gather_per_sharded_dense(served):
    """gemma3-1b's decode step: one gather per sharded ``Dense``, one for
    the embedding, one for the tied head's partial logits."""
    tparams = pair("gemma3-1b")[3]
    dense = sum(isinstance(m, Dense) for m in tparams.modules())
    for r in served["gemma3-1b"]:
        assert r["gathers"]["collectives"] == dense + 2, r["gathers"]
        assert r["gathers"]["bytes"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_gathers_equal_live_ranks(served, arch):
    """``launch.dryrun.dry_cell`` of one decode step on each rank's
    coordinates of a dry (2, 2) mesh, the meta device: the gathers and
    bytes the live gloo ranks counted."""
    from repro_torch.launch.dryrun import dry_cell
    from repro_torch.launch.mesh import dry_mesh
    cfg = pair(arch)[1]
    batch, forced = _inputs(arch)
    npfx = 16 if "prefix_embeds" in batch else 0
    frames = batch["frames"].shape[1] if "frames" in batch else 1024
    for rank, r in enumerate(served[arch]):
        mesh = dry_mesh(MESH, rank)
        assert mesh.coords == r["coords"]
        got = dry_cell(cfg, "decode", mesh, batch=B,
                       seq=npfx + P + STEPS + 1, frames=frames,
                       param_dtype=torch.float32,
                       cache_dtype=torch.float32)
        assert (got["gathers"], got["gather_bytes"]) == (
            r["gathers"]["collectives"], r["gathers"]["bytes"]), r["coords"]
        assert (got["row0"], got["rows"]) == (r["row0"], r["rows"])


def test_unported_engine_options_raise(served):
    """A draft model over the mesh (``make_engine(mesh=, draft_cfg=)``,
    once refused) gives the one-rank engine's greedy tokens and
    ``SpecStats`` with the same draft, on each rank's rows; the
    continuous engine still takes no mesh, as the reference's."""
    from repro_torch.launch.serve import main as serve_main
    cfg, tparams = pair("gemma3-1b")[1], pair("gemma3-1b")[3]
    dcfg, dparams = _draft()
    batch, _ = _inputs("gemma3-1b")
    one = make_engine(cfg, batch=B, prompt_len=P, max_new=NEW,
                      param_dtype=torch.float32, cache_dtype=torch.float32,
                      speculate_k=SPEC_K, draft_cfg=dcfg, device="cpu")
    want = one.generate_with_state(
        tparams, {"tokens": torch.from_numpy(batch["tokens"])},
        draft_params=dparams)
    assert int(want.spec.rounds.sum()) > 0
    for r in served["gemma3-1b"]:
        rows = slice(r["row0"], r["row0"] + r["rows"])
        np.testing.assert_array_equal(r["tokens"]["draft"],
                                      want.tokens.numpy()[rows],
                                      err_msg=str(r["coords"]))
        for got, ref in zip(r["draft_stats"], want.spec):
            np.testing.assert_array_equal(got, ref.numpy()[rows])
    with pytest.raises(SystemExit, match="--continuous takes no mesh"):
        serve_main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
                    "--continuous", "--nproc", "4"])


def _launcher(*extra):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-1b", "--reduced", "--device", "cpu", "--batch", "4",
         "--prompt-len", "16", "--gen", "4", *extra],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    at = lines.index("generated token ids:")
    return lines[at + 1:at + 1 + 4], r.stdout


def test_launcher_mesh_tokens_equal_one_rank():
    one, _ = _launcher("--nproc", "1")
    tp, out = _launcher("--nproc", "4", "--mesh-model", "2")
    assert tp == one
    assert "mesh (data 2, model 2)" in out


def test_launcher_draft_config_mesh_tokens_equal_one_rank():
    """``--draft-config`` with ``--nproc 4 --mesh-model 2``: the rows'
    tokens equal ``--nproc 1``'s with the same draft."""
    spec = ["--speculate-k", "2", "--draft-config", "gemma3-1b"]
    one, out = _launcher("--nproc", "1", *spec)
    assert "speculative: k=2" in out
    tp, _ = _launcher("--nproc", "4", "--mesh-model", "2", *spec)
    assert tp == one
