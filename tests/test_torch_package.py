"""Package rules of the port: no JAX and nothing of ``repro`` inside
``repro_torch`` or ``chip_smoke.py``; CUDA by default, the CPU only when
asked; the kernel counter moves only where the kernel launches."""
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.gossip_mix import (gossip_mix_slots,
                                            gossip_mix_stacked)
from repro_torch.kernels.paged_flash_attention import \
    paged_flash_attention_fwd
from repro_torch.kernels.quantized_gossip import (quantize_ef,
                                                  quantized_gossip_mix)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(?:jax|repro)(?:[.\s,]|$)",
                       re.MULTILINE)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_every_module_leaves_jax_and_repro_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert {"repro_torch.launch.serve", "repro_torch.compress.codecs",
            "repro_torch.compress.config", "repro_torch.compress.mixing",
            "repro_torch.kernels.quantized_gossip",
            "repro_torch.kernels.paged_flash_attention",
            "repro_torch.serve.continuous",
            "repro_torch.serve.paged", "repro_torch.core.ppermute_plan",
            "repro_torch.dist.gossip", "repro_torch.dist.steps",
            "repro_torch.kernels.gossip_mix",
            "repro_torch.launch.distributed",
            "repro_torch.launch.train", "repro_torch.launch.dryrun",
            "repro_torch.launch.shapes", "repro_torch.analysis.flops",
            "repro_torch.optim.sgd"} <= set(_modules())


def test_sources_import_no_jax_and_no_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if FORBIDDEN.search(f.read_text())]
    assert not offenders
    assert FORBIDDEN.search("from repro.kernels import ops\n")
    assert FORBIDDEN.search("import jax.numpy as jnp\n")
    assert not FORBIDDEN.search("from repro_torch.kernels import ops\n")


def test_serve_launcher_without_card_exits_with_message():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-1b", "--reduced"], cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA device" in r.stderr and "--device cpu" in r.stderr


def test_train_launcher_without_card_exits_with_message():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma3-1b", "--reduced", "--nproc", "2"], cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA device" in r.stderr and "--device cpu" in r.stderr


@pytest.mark.parametrize("extra", [["--continuous"],
                                   ["--continuous", "--speculate-k", "2"]])
def test_continuous_launcher_without_card_exits_with_message(extra):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-1b", "--reduced", *extra], cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA device" in r.stderr and "--device cpu" in r.stderr


def test_fixed_batch_speculation_is_not_ported():
    """Fixed-batch speculation is ported (tests/test_torch_spec.py runs the
    launcher with it on the CPU); what the launcher still refuses is the
    reference's: a self-speculative depth and a draft model together."""
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="not both"):
        serve.main(["--arch", "gemma3-1b", "--reduced", "--speculate-k", "2",
                    "--draft-layers", "1", "--draft-config", "gemma3-1b",
                    "--device", "cpu"])


def test_entry_points_default_to_cuda():
    from repro_torch.models import model as M
    from repro_torch.serve import ContinuousEngine, make_engine
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("gemma3-1b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine(cfg, batch=1, prompt_len=8, max_new=2)
    layout = M.PagedCacheLayout(page_size=4, num_pages=9,
                                max_pages_per_slot=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_paged_cache(cfg, layout)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousEngine(cfg, slots=2, layout=layout, max_new=2,
                         buckets=(4, 8))
    eng = ContinuousEngine(cfg, slots=2, layout=layout, max_new=2,
                           buckets=(4, 8), device="cpu")
    assert eng.device.type == "cpu"
    assert eng.pools["prologue"][0]["attn"]["k"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device()
    assert repro_torch.resolve_device("cpu").type == "cpu"


def test_training_entry_points_default_to_cuda():
    from repro_torch.configs.paper_mlp import MLPConfig
    from repro_torch.models import mlp
    from repro_torch.optim.decentralized import make_method
    from repro_torch.sim.engine import node_stack, simulate_decentralized
    from repro_torch.topology import TopologySpec, build_schedule
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        mlp.init(MLPConfig())
    params = mlp.init(MLPConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        node_stack(params, 3)
    sched = build_schedule(TopologySpec(name="base", n=3, k=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        sched.as_dense_stack(4)
    assert sched.as_dense_stack(4, device="cpu")[0].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate_decentralized(
            loss_fn=mlp.loss_fn, params=params, method=make_method("dsgdm"),
            schedule=sched, batches=lambda r: None, steps=2, eta=0.1)


def test_cpu_attention_does_not_touch_the_kernel_counter():
    q = torch.randn(1, 3, 4, 16)
    k = torch.randn(1, 5, 2, 16)
    before = flash_attention_fwd.launches
    ops.sdpa(q, k, k)
    ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        k.transpose(1, 2))
    assert flash_attention_fwd.launches == before


def test_cpu_decode_attention_does_not_touch_the_kernel_counter():
    q = torch.randn(2, 3, 4, 16)
    k = torch.randn(2, 9, 1, 16)
    before = flash_attention_fwd.launches
    ops.sdpa_decode(q, k, k, q_start=torch.tensor([0, 5]),
                    k_valid_len=torch.tensor([3, 8]))
    assert flash_attention_fwd.launches == before


def test_cpu_paged_attention_does_not_touch_the_kernel_counter():
    q = torch.randn(2, 3, 4, 16)
    pool = torch.randn(5, 4, 2, 16)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    before = paged_flash_attention_fwd.launches
    ops.paged_sdpa(q, pool, pool, table, q_start=torch.tensor([0, 2]),
                   k_valid_len=torch.tensor([3, 5]))
    assert paged_flash_attention_fwd.launches == before


def test_cpu_quantize_does_not_touch_the_kernel_counter():
    from repro_torch.compress import CompressionConfig, compressed_dense_mix
    x = {"w": torch.randn(3, 40)}
    before = quantize_ef.launches
    ops.quantize_payload(torch.randn(4, 32), torch.randn(4, 32), fmt="int8",
                         key=3)
    for codec in ("int8", "fp8"):
        compressed_dense_mix(torch.eye(3), x, None,
                             CompressionConfig(codec=codec, chunk=32), 0)
    assert quantize_ef.launches == before


def test_cpu_gossip_mix_does_not_touch_the_kernel_counters():
    a = torch.randn(3, 5)
    before = (gossip_mix_slots.launches, gossip_mix_stacked.launches,
              quantized_gossip_mix.launches)
    ops.gossip_mix([a, a], [0.5, 0.5])
    ops.gossip_mix(torch.stack([a, a]), [0.5, 0.5])
    q = torch.zeros(3, 5, dtype=torch.int8)
    ops.quantized_gossip_mix(a, [q], [torch.ones(3, 1)], [0.5, 0.5])
    assert (gossip_mix_slots.launches, gossip_mix_stacked.launches,
            quantized_gossip_mix.launches) == before


def test_kernel_wrapper_takes_cuda_tensors_only():
    q = torch.randn(1, 3, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, q, q)
    x = torch.randn(4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_ef(x, None, 3, fmt="int8")
    table = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_flash_attention_fwd(q, q, q, table, q_start=0, k_valid_len=1)
    with pytest.raises(ValueError, match="CUDA"):
        gossip_mix_slots([x, x], [0.5, 0.5])
    with pytest.raises(ValueError, match="CUDA"):
        gossip_mix_stacked(torch.stack([x, x]), [0.5, 0.5])
    with pytest.raises(ValueError, match="CUDA"):
        quantized_gossip_mix(x, [x.to(torch.int8)], [x[:, :1]], [0.5, 0.5])


def test_kernels_build_into_the_checkout_only(tmp_path):
    from repro_torch.kernels import _build
    assert _build.build_dir() == ROOT / "build" / "repro_torch"
    # a copy outside a checkout's src/ (as a non-editable install is)
    # refuses to build rather than write beside the installed package
    shutil.copytree(PKG, tmp_path / "site" / "repro_torch")
    code = ("from repro_torch.kernels import _build\n"
            "_build.library_path('flash_attention')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env={"PYTHONPATH": str(tmp_path / "site"),
                            "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "checkout" in r.stderr
    assert not (tmp_path / "build").exists()


def test_each_library_hashes_its_own_source(tmp_path):
    """Editing one ``.cu`` renames that library only; every library path
    stays in the checkout's ``build/repro_torch``."""
    checkout = tmp_path / "checkout"
    shutil.copytree(PKG, checkout / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    names = sorted(f.stem for f in (PKG / "kernels" / "csrc").glob("*.cu"))
    assert {"flash_attention", "fused_dsgd", "gossip_mix",
            "paged_flash_attention", "quantized_gossip"} <= set(names)
    code = ("from repro_torch.kernels import _build\n"
            f"for name in {names!r}:\n"
            "    print(_build.library_path(name))\n")

    def paths():
        r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                           env={"PYTHONPATH": str(checkout / "src"),
                                "PATH": "/usr/bin:/bin"},
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        return dict(zip(names, r.stdout.split()))

    before = paths()
    for name, path in before.items():
        assert Path(path).parent == checkout / "build" / "repro_torch"
        assert Path(path).name.startswith(f"lib{name}-")
    src = checkout / "src" / "repro_torch" / "kernels" / "csrc" / \
        "fused_dsgd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = paths()
    for name in names:
        assert (after[name] != before[name]) == (name == "fused_dsgd"), name
    assert not (checkout / "build").exists()


def test_unported_architectures_raise():
    """Every reference arch is ported; an unknown name raises and lists
    the known ones."""
    with pytest.raises(KeyError, match="llava-next-34b"):
        get_config("llava-next-35b")
    assert get_config("gemma3_1b").name == "gemma3-1b"
