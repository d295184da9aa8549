"""The kernel build's hash follows the headers a source includes: an edit
to ``csrc/flash_core.cuh`` rebuilds both attention libraries and no
other, and one to ``csrc/multi_tensor.cuh`` the fused DSGD, gossip
combine and quantized gossip libraries and no other.  Runs on the CPU:
it computes library paths, it builds nothing."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (aligned, choose_splits,
                                                 split_scratch)

PKG = Path(_build.__file__).resolve().parents[1]
NAMES = ("flash_attention", "fused_dsgd", "gossip_mix",
         "paged_flash_attention", "quantized_gossip")


def test_attention_sources_include_the_shared_core():
    for name in ("flash_attention", "paged_flash_attention"):
        assert [p.name for p in _build.sources(name)] == [
            f"{name}.cu", "flash_core.cuh"]
    for name in ("fused_dsgd", "gossip_mix", "quantized_gossip"):
        assert [p.name for p in _build.sources(name)] == [
            f"{name}.cu", "multi_tensor.cuh"]


@pytest.mark.parametrize("edit,changed", [
    ("flash_core.cuh", {"flash_attention", "paged_flash_attention"}),
    ("paged_flash_attention.cu", {"paged_flash_attention"}),
    ("multi_tensor.cuh", {"fused_dsgd", "gossip_mix", "quantized_gossip"}),
    ("quantized_gossip.cu", {"quantized_gossip"}),
])
def test_editing_a_header_renames_every_library_that_includes_it(
        tmp_path, edit, changed):
    checkout = tmp_path / "checkout"
    shutil.copytree(PKG, checkout / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from repro_torch.kernels import _build\n"
            f"for name in {NAMES!r}:\n"
            "    print(_build.library_path(name))\n")

    def paths():
        r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                           env={"PYTHONPATH": str(checkout / "src"),
                                "PATH": "/usr/bin:/bin"},
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        return dict(zip(NAMES, r.stdout.split()))

    before = paths()
    src = checkout / "src" / "repro_torch" / "kernels" / "csrc" / edit
    src.write_text(src.read_text() + "\n// edited\n")
    after = paths()
    for name in NAMES:
        assert (after[name] != before[name]) == (name in changed), name
    assert not (checkout / "build").exists()


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    lib = tmp_path / "libx-0.so"
    monkeypatch.setattr(_build, "library_path", lambda name: lib)
    assert _build.ptxas_report("x") == []
    lib.with_suffix(".ptxas.txt").write_text(
        "ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1av\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
        "loads\n"
        "ptxas info    : Used 128 registers, 376 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1bv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 40 registers, 376 bytes cmem[0]\n")
    assert _build.ptxas_report("x") == [("_Z1av", 128, 12), ("_Z1bv", 40, 0)]


def test_split_choice_and_scratch_need_no_card():
    """The wrappers' launch plan: an explicit ``kv_splits`` is taken (up to
    the chunk count), a call of more than 64 rows per kv head is never
    split, and an unsplit call allocates no scratch; a split call's
    scratch holds Dv partial outputs and an (m, l) pair per row and
    chunk, in one allocation."""
    cpu = torch.device("cpu")
    kw = dict(blocks=4, rows=4, nchunks=17, device=cpu)
    assert choose_splits(1, **kw) == 1
    assert choose_splits(5, **kw) == 5
    assert choose_splits(40, **kw) == 17
    with pytest.raises(ValueError, match="kv_splits"):
        choose_splits(0, **kw)
    assert choose_splits(None, blocks=256, rows=4096, nchunks=17,
                         device=cpu) == 1
    assert split_scratch(1, B=4, KV=1, row_tiles=1, block_rows=16,
                         nchunks=17, Dv=256, device=cpu) == (None,) * 3
    buf, part_o, part_ml = split_scratch(3, B=4, KV=1, row_tiles=2,
                                         block_rows=16, nchunks=17, Dv=256,
                                         device=cpu)
    n = 4 * 2 * 16 * 17
    assert buf.dtype == torch.float32 and buf.numel() == n * (256 + 2)
    assert part_o == buf.data_ptr() and part_ml == part_o + 4 * n * 256


def test_aligned_copies_only_what_16_byte_copies_cannot_read():
    t = torch.arange(2 * 8 * 64, dtype=torch.bfloat16).view(2, 8, 1, 64)
    for view in (t, t.transpose(0, 1), t[:, 1:]):   # whole-row strides
        assert aligned(view) is view
    odd = torch.arange(2 * 8 * 64 + 1, dtype=torch.bfloat16)[1:].view(
        2, 8, 1, 64)              # contiguous, but 2 bytes off alignment
    rows = torch.arange(2 * 8 * 68, dtype=torch.bfloat16).view(
        2, 8, 1, 68)[..., :64]    # rows 136 bytes apart
    for view in (odd, rows):
        fixed = aligned(view)
        assert fixed is not view and fixed.data_ptr() % 16 == 0
        assert fixed.is_contiguous() and torch.equal(fixed, view)
