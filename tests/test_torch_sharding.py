"""The port's sharding rules and meshes (``repro_torch.dist.sharding``,
``repro_torch.launch.mesh``) against the reference's, with no ranks.

For each of the 10 archs of ``ARCH_NAMES``, both production meshes and
both contexts, the port's tables equal the reference's: the parameter
specs (serve, and train with and without the node axis), the batch
specs (node-stacked in train, not in serve) and the cache specs.  The
reference's shape trees come from ``jax.eval_shape`` once per arch; its
specs are taken with the same fake mesh as the port's.  The reference
stacks each pattern position's blocks along a leading dim, which its
specs replicate; the port keeps one tensor per block, so that entry is
dropped before comparing.  A few drawn mesh sizes compare the tables the
same way, as ``tests/test_sharding_props.py`` checks the reference's.
The shard arithmetic (``convert.shard_for_rank`` / ``unshard_ranks``)
round-trips bit for bit on a drawn mesh.
"""
import functools
import re
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jget_config
from repro.dist import sharding as JS
from repro.dist.steps import node_stack_specs
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.convert import shard_for_rank, unshard_ranks
from repro_torch.dist import sharding as S
from repro_torch.launch import mesh as TMESH
from repro_torch.models import model as TM


@dataclass
class FakeMesh:
    shape: dict

    @property
    def axis_names(self):
        return tuple(self.shape)


MESHES = {
    "single": FakeMesh({"data": 16, "model": 16}),
    "multi": FakeMesh({"pod": 2, "data": 16, "model": 16}),
}
_BLOCK = re.compile(r"^(.*\bblocks)\.(\d+)\.(\d+)\.(.*)$")


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """The reference's parameter and (B = 128, S = 256) cache shape
    trees, and the port's flat parameter and cache shapes."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jparams = JM.param_specs(jcfg, jnp.bfloat16)
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, 128, 256,
                                                  jnp.bfloat16))
    tparams = TM.param_specs(cfg, torch.bfloat16)
    tcache = TM.init_cache(cfg, 128, 256, torch.bfloat16, device="meta")
    return jparams, jcache, tparams, tcache


def _flat_ref(tree):
    """{dotted path: spec as a tuple} of a reference spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in leaves}


def _flat_port(tree, path=""):
    """{dotted path: spec} of a port spec tree (dicts and lists of layers;
    a spec is a tuple)."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat_port(v, f"{path}{k}."))
        return out
    return {path[:-1]: tree}


def _as_ref(port: dict, lead: int = 0) -> dict:
    """The port's flat specs keyed and shaped as the reference's: a
    per-block key ``….blocks.<b>.<pos>.…`` becomes the stacked leaf's
    ``….blocks.<pos>.…``, its blocks entry (after ``lead`` leading
    entries) put back as None; every block must agree."""
    out = {}
    for key, spec in port.items():
        m = _BLOCK.match(key)
        if m is None:
            out[key] = spec
            continue
        head, _, pos, rest = m.groups()
        spec = spec[:lead] + (None,) + spec[lead:]
        ref_key = f"{head}.{pos}.{rest}"
        assert out.setdefault(ref_key, spec) == spec, key
    return out


def _pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def _param_tables(arch, mesh, context, node_axis):
    jparams, _, tparams, _ = _shapes(arch)
    jrules = JS.make_rules(mesh, arch_name=arch, context=context)
    rules = S.make_rules(mesh, arch_name=arch, context=context)
    assert (rules.tp, rules.dp, rules.node_axis, rules.n_nodes) == \
        (jrules.tp, jrules.dp, jrules.node_axis, jrules.n_nodes)
    if node_axis:
        n = rules.n_nodes
        jparams = node_stack_specs(jparams, n)
        tparams = {k: torch.empty((n,) + tuple(v.shape), device="meta")
                   for k, v in tparams.items()}
    want = _flat_ref(JS.param_partition_specs(jparams, jrules,
                                              node_axis=node_axis))
    ndim = {k: len(v.shape) for k, v in _flat_leaves(jparams).items()}
    want = {k: _pad(v, ndim[k]) for k, v in want.items()}
    got = _as_ref(S.param_partition_specs(tparams, rules,
                                          node_axis=node_axis),
                  lead=1 if node_axis else 0)
    return got, want


def _flat_leaves(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in leaves}


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("context", ["train", "serve"])
def test_param_tables_equal_reference(arch, mesh_name, context):
    mesh = MESHES[mesh_name]
    for node_axis in ((True, False) if context == "train" else (False,)):
        got, want = _param_tables(arch, mesh, context, node_axis)
        assert got == want, (node_axis, {
            k: (got.get(k), want.get(k)) for k in set(got) | set(want)
            if got.get(k) != want.get(k)})


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_cache_tables_equal_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]
    _, jcache, _, tcache = _shapes(arch)
    for context in ("train", "serve"):
        jrules = JS.make_rules(mesh, arch_name=arch, context=context)
        rules = S.make_rules(mesh, arch_name=arch, context=context)
        stacked = context == "train"
        for shape in ((rules.n_nodes, 64, 256) if stacked else (128, 256),
                      (3, 5, 7), (2,)):
            jb = {"tokens": jax.ShapeDtypeStruct(shape, jnp.int32)}
            tb = {"tokens": torch.empty(shape, device="meta")}
            want = JS.batch_partition_specs(jb, jrules,
                                            node_stacked=stacked)
            got = S.batch_partition_specs(tb, rules, node_stacked=stacked)
            assert got["tokens"] == _pad(want["tokens"], len(shape)), shape
        want = _flat_ref(JS.cache_partition_specs(jcache, jrules))
        ndim = {k: len(v.shape) for k, v in _flat_leaves(jcache).items()}
        want = {k: _pad(v, ndim[k]) for k, v in want.items()}
        got = _as_ref(_flat_port(S.cache_partition_specs(tcache, rules)))
        assert got == want, context


@settings(max_examples=6, deadline=None)
@given(pod=st.integers(1, 3), data=st.integers(1, 12),
       model=st.integers(1, 12),
       arch=st.sampled_from(["granite-8b", "grok-1-314b"]))
def test_tables_equal_reference_on_drawn_meshes(pod, data, model, arch):
    """Odd mesh geometries (1-sized axes, sizes that do not divide)."""
    for mesh in (FakeMesh({"data": data, "model": model}),
                 FakeMesh({"pod": pod, "data": data, "model": model})):
        for context in ("train", "serve"):
            for node_axis in (True, False):
                got, want = _param_tables(arch, mesh, context, node_axis)
                assert got == want, (mesh, context, node_axis)


def test_rules_reject_unknown_context():
    with pytest.raises(ValueError, match="context"):
        S.make_rules(MESHES["single"], arch_name="gemma3-1b",
                     context="eval")


def test_meshes():
    single, multi = (TMESH.make_production_mesh(),
                     TMESH.make_production_mesh(multi_pod=True))
    assert (single.shape, single.axis_names) == \
        ({"data": 16, "model": 16}, ("data", "model"))
    assert multi.axis_names == ("pod", "data", "model") and \
        not multi.live
    with pytest.raises(ValueError, match="shape-only"):
        single.group("model")
    # row-major, as jax.make_mesh lays out devices
    assert [tuple(TMESH.rank_coords(multi, r).values())
            for r in (0, 1, 16, 256, 511)] == \
        [(0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 0), (1, 15, 15)]
    # one process with no group: a live (1, 1) host mesh
    host = TMESH.make_host_mesh()
    assert host.live and host.shape == {"data": 1, "model": 1} \
        and host.coords == {"data": 0, "model": 0}
    with pytest.raises(ValueError, match="divide"):
        TMESH.make_host_mesh(model=2)


@settings(max_examples=5, deadline=None)
@given(data=st.integers(1, 3), model=st.integers(1, 4),
       arch=st.sampled_from(["gemma3-1b", "grok-1-314b", "mamba2-2.7b"]))
def test_shards_reassemble_bit_for_bit(data, model, arch):
    cfg = get_config(arch).reduced()
    mesh = FakeMesh({"data": data, "model": model})
    rules = S.make_rules(mesh, arch_name=arch, context="serve")
    full = TM.init(cfg, seed=3, device="cpu").state_dict()
    specs = S.param_partition_specs(full, rules)
    shards = [shard_for_rank(dict(full), specs, mesh,
                             TMESH.rank_coords(mesh, r))
              for r in range(data * model)]
    for s in shards:
        for k, t in s.items():
            assert tuple(t.shape) == S.local_shape(full[k].shape, specs[k],
                                                   mesh)
    back = unshard_ranks(shards, specs, mesh)
    assert back.keys() == full.keys()
    for k in full:
        assert torch.equal(back[k], full[k]), k
    # shard_for_rank empties the dict it is given
    given_ = dict(full)
    shard_for_rank(given_, specs, mesh, TMESH.rank_coords(mesh, 0))
    assert not given_
    # ranks that hold the same slice must hold the same bits
    if data > 1:
        bad = [dict(s) for s in shards]
        key = "final_norm.scale"
        bad[-1][key] = bad[-1][key] + 1
        with pytest.raises(ValueError, match="differ"):
            unshard_ranks(bad, specs, mesh)
    assert np.isfinite(sum(float(t.float().sum()) for t in back.values()))
