#!/usr/bin/env python3
"""Device time of the port's attention kernels at the main paths' shapes,
with parts of the kernel body taken out, on one CUDA card.

    python3 scripts/attention_ablation.py [--variants base,noqk,...]
    python3 scripts/attention_ablation.py --phases

Each variant is ``csrc/`` copied into ``build/attention_ablation/<name>/``
with one or more lines of ``flash_core.cuh`` replaced, built with the
port's nvcc flags and loaded in place of the port's library.  Only
``base`` computes attention; the others measure what a part costs
(their results are wrong by construction).  Times are profiler sums of
the kernels' device time over 20 back-to-back calls, per call (no L2
flush: the K/V of a call fit the 50 MB L2 either way), beside the same
for ``scaled_dot_product_attention`` on the same inputs.  The card's
name and power limit come first.

``--phases`` instead builds the committed kernel with ``clock64``
stamps around the phases of a tile (warp 0 of each block's first team)
and prints the cycles each phase takes per tile, at prefill and
training shapes: where a tile's time goes inside the block.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
QK = ("for (int kk = 0; kk < D / 16; ++kk) {",
      "for (int kk = 0; kk < 0; ++kk) {")
PV = ("for (int kk = 0; kk < BK / 16; ++kk) {",
      "for (int kk = 0; kk < 0; ++kk) {")
LOAD = ("    if (c + 1 < c_end) load_tile(buf ^ 1);\n", "")
FOLD = ("O[j][e] = fold_elem(fo[e >> 1], O[j][e], acc[j][e]);",
        "O[j][e] += acc[j][e];")
LO = ("            mma_bf16(acc[2 * j2], al, bb[0], bb[1]);\n"
      "            mma_bf16(acc[2 * j2 + 1], ah, bb[2], bb[3]);\n"
      "            mma_bf16(acc[2 * j2 + 1], al, bb[2], bb[3]);\n",
      "            mma_bf16(acc[2 * j2 + 1], ah, bb[2], bb[3]);\n")
EXP = ("ok ? expf(__fsub_rn(s[j][e], mrow[rb])) : 0.f",
       "ok ? __fsub_rn(s[j][e], mrow[rb]) : 0.f")
ORDER = ("  const int rt = (int)(p.row_tiles - 1 - blockIdx.x / p.B);",
         "  const int rt = (int)(blockIdx.x / p.B);")
VARIANTS = {
    "base": [],              # the committed kernel
    "ascending": [ORDER],    # row tiles in ascending order
    "nolo": [LO],            # P V without P's low bf16 part
    "noexp": [EXP],          # no expf in the softmax
    "noqk": [QK],            # no Q K^T products
    "nopv": [PV],            # no P V products
    "noload": [LOAD],        # no K/V tile loads after the first
    "nofold": [FOLD],        # a plain sum for the chunk fold
    "skeleton": [QK, PV, LOAD, FOLD],
}


def build(name, edits, nvcc, flags):
    out = ROOT / "build" / "attention_ablation" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch" / "kernels" / "csrc", out)
    core = out / "flash_core.cuh"
    text = core.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: the line to replace is not "
                             f"in flash_core.cuh once: {old!r}")
        text = text.replace(old, new)
    core.write_text(text)
    libs = []
    for lib in ("flash_attention", "paged_flash_attention"):
        so = out / f"lib{lib}.so"
        r = subprocess.run([nvcc, *flags, "-o", str(so),
                            str(out / f"{lib}.cu")],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"variant {name}: nvcc failed\n{r.stderr}")
        libs.append(so)
    return libs


PHASE_EDITS = [
    ("constexpr int kStages = 2;\n",
     "constexpr int kStages = 2;\n"
     "__device__ unsigned long long g_phase[4096][8];\n"),
    ("  for (int c = c_begin; c < c_end; ++c) {\n"
     "    const int buf = (c - c_begin) & 1;\n",
     "  long long ph[6] = {0, 0, 0, 0, 0, 0};\n"
     "  const long long ph_start = clock64();\n"
     "  for (int c = c_begin; c < c_end; ++c) {\n"
     "    const int buf = (c - c_begin) & 1;\n"
     "    long long t0 = clock64(), t2 = 0, t3 = 0, t4 = 0;\n"),
    ("    cp_async_wait<0>();\n    __syncthreads();\n",
     "    cp_async_wait<0>();\n    __syncthreads();\n"
     "    const long long t1 = clock64();\n"),
    ("      // ---- scale, softcap and mask by select; the tile's row maxima",
     "      t2 = clock64();\n"
     "      // ---- scale, softcap and mask by select; the tile's row maxima"),
    ("      team_sync(team);\n#pragma unroll\n      for (int r = 0; r < 2; ++r)"
     " {\n        float m = red_max",
     "      team_sync(team);\n      t3 = clock64();\n#pragma unroll\n"
     "      for (int r = 0; r < 2; ++r) {\n        float m = red_max"),
    ("      team_sync(team);\n#pragma unroll\n      for (int r = 0; r < 2; ++r)"
     " {\n        float l = red_sum",
     "      team_sync(team);\n      t4 = clock64();\n#pragma unroll\n"
     "      for (int r = 0; r < 2; ++r) {\n        float l = red_sum"),
    ("    // ---- fold the chunk's partial, or write it for combine_kernel",
     "    if (active) {\n"
     "      const long long t5 = clock64();\n"
     "      ph[0] += t1 - t0; ph[1] += t2 - t1; ph[2] += t3 - t2;\n"
     "      ph[3] += t4 - t3; ph[4] += t5 - t4; ph[5] += 1;\n"
     "    }\n"
     "    // ---- fold the chunk's partial, or write it for combine_kernel"),
    ("  cp_async_wait<0>();\n\n  if (!unsplit) return;",
     "  cp_async_wait<0>();\n"
     "  if (threadIdx.x == 0 && blockIdx.x < 4096) {\n"
     "    for (int i = 0; i < 6; ++i) g_phase[blockIdx.x][i] = ph[i];\n"
     "    g_phase[blockIdx.x][6] = clock64() - ph_start;\n"
     "  }\n\n  if (!unsplit) return;"),
]
PHASES = ("wait + block barrier", "tile copies issued + Q K^T",
          "mask, max, team barrier", "exp, sums, P stores, team barrier",
          "P V")


def phase_profile(torch, root_flags, nvcc):
    """Cycles per tile by phase, from a clock64-stamped build."""
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    out = ROOT / "build" / "attention_ablation" / "phases"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch" / "kernels" / "csrc", out)
    core = out / "flash_core.cuh"
    text = core.read_text()
    for old, new in PHASE_EDITS:
        if text.count(old) != 1:
            raise SystemExit(f"--phases: the line to stamp is not in "
                             f"flash_core.cuh once: {old!r}")
        text = text.replace(old, new)
    core.write_text(text)
    src = out / "flash_attention.cu"
    src.write_text(src.read_text() + (
        "\nextern \"C\" int repro_phase_read(void* dst) {\n"
        "  return (int)cudaMemcpyFromSymbol(dst, flash::g_phase,\n"
        "                                   sizeof(flash::g_phase));\n}\n"))
    so = out / "libflash_attention.so"
    r = subprocess.run([nvcc, *root_flags, "-o", str(so), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"--phases: nvcc failed\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    _build._loaded["flash_attention"] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen,
                           device=dev).to(torch.bfloat16)

    for name, B, T, S, kw in (
            ("prefill,global", 4, 1024, 1088, dict(q_start=0,
                                                   k_valid_len=1024)),
            ("prefill,local", 4, 1024, 1088, dict(q_start=0,
                                                  k_valid_len=1024,
                                                  window=512)),
            ("train,global", 2, 1024, 1024, dict())):
        q, k, v = rand(B, T, 4, 256), rand(B, S, 1, 256), rand(B, S, 1, 256)
        for _ in range(3):
            FA.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        buf = np.zeros((4096, 8), dtype=np.uint64)
        if lib.repro_phase_read(buf.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise SystemExit("--phases: reading the stamps failed")
        n = FA.flash_attention_fwd.last_launch["grid"][0]
        a = buf[:n].astype(np.float64)
        tiles = a[:, 5].sum()
        per = [a[:, i].sum() / tiles for i in range(5)]
        rest = (a[:, 6].sum() - a[:, :5].sum()) / tiles
        print(f"{name}: {n} blocks, {int(tiles)} tiles walked by team 0; "
              f"cycles per tile: " + "; ".join(
                  f"{label} {v:.0f}" for label, v in zip(PHASES, per))
              + f"; fold and the rest {rest:.0f}; a block's walk: mean "
              f"{a[:, 6].mean():.0f}, max {a[:, 6].max():.0f} cycles",
              flush=True)


def device_us(torch, fn, n=20):
    """(per-call device time of the port's kernels, of everything else)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    mine = other = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t = e.time_range.elapsed_us() / n
            if "attn_kernel" in e.name or "combine_kernel" in e.name:
                mine += t
            else:
                other += t
    return mine, other


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--phases", action="store_true",
                    help="cycles per tile by phase instead of variants")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("attention_ablation: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_flash_attention as PA
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    names = args.variants.split(",")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    if args.phases:
        phase_profile(torch, flags, _build.nvcc_path())
        return
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(
            lambda n: build(n, VARIANTS[n], _build.nvcc_path(), flags),
            names)))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen,
                           device=dev).to(torch.bfloat16)

    # gemma3-1b: 4 q / 1 kv heads of 256, local window 512
    cases = []
    for layer, window in (("global", None), ("local", 512)):
        q, k, v = rand(4, 1024, 4, 256), rand(4, 1088, 1, 256), \
            rand(4, 1088, 1, 256)
        cases.append((f"prefill,{layer}", "dense", (q, k, v),
                      dict(q_start=0, k_valid_len=1024, window=window)))
        q, k, v = rand(2, 1024, 4, 256), rand(2, 1024, 1, 256), \
            rand(2, 1024, 1, 256)
        cases.append((f"train,{layer}", "dense", (q, k, v),
                      dict(window=window)))
        q, k, v = rand(4, 1, 4, 256), rand(4, 1088, 1, 256), \
            rand(4, 1088, 1, 256)
        cases.append((f"decode@1086,{layer}", "dense", (q, k, v),
                      dict(q_start=1086, k_valid_len=1087, window=window)))
    # the continuous path: 8 slots, page 16, 69 pages each
    pos = torch.tensor([64, 207, 351, 512, 640, 801, 1000, 1086],
                       dtype=torch.int32, device=dev)
    kp, vp = rand(8 * 69 + 1, 16, 1, 256), rand(8 * 69 + 1, 16, 1, 256)
    table = torch.arange(1, 8 * 69 + 1, dtype=torch.int32,
                         device=dev).reshape(8, 69)
    for Tq in (1, 5):
        cases.append((f"paged,Tq={Tq}", "paged",
                      (rand(8, Tq, 4, 256), kp, vp, table),
                      dict(q_start=pos, k_valid_len=pos + Tq)))

    for cname, kind, tensors, kw in cases:
        for vname in names:
            flash_lib, paged_lib = (ctypes.CDLL(str(p)) for p in libs[vname])
            _build._loaded["flash_attention"] = flash_lib
            _build._loaded["paged_flash_attention"] = paged_lib
            splits = ((None, 1) if vname == "base" and "prefill" not in cname
                      and "train" not in cname else (None,))
            for kv_splits in splits:
                fn = FA.flash_attention_fwd if kind == "dense" else \
                    PA.paged_flash_attention_fwd
                mine, _ = device_us(torch, lambda: fn(*tensors, **kw,
                                                      kv_splits=kv_splits))
                print(f"{cname:18s} {vname:9s} kv_splits={kv_splits} "
                      f"{mine:9.2f} us ({fn.last_launch})", flush=True)
        q = tensors[0]
        if kind == "dense":
            k, v = tensors[1], tensors[2]
        else:
            B, S = table.shape[0], table.shape[1] * kp.shape[1]
            k = kp[table.long()].reshape(B, S, 1, 256)
            v = vp[table.long()].reshape(B, S, 1, 256)
        Tq, S = q.shape[1], k.shape[1]
        q0 = torch.as_tensor(kw.get("q_start", S - Tq),
                             device=dev).reshape(-1, 1, 1)
        kv = torch.as_tensor(kw.get("k_valid_len", S),
                             device=dev).reshape(-1, 1, 1)
        qpos = q0 + torch.arange(Tq, device=dev)[None, :, None]
        kpos = torch.arange(S, device=dev)[None, None, :]
        mask = (kpos <= qpos) & (kpos < kv)
        if kw.get("window"):
            mask &= kpos > qpos - kw["window"]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        _, other = device_us(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True))
        print(f"{cname:18s} sdpa      {other:9.2f} us", flush=True)


if __name__ == "__main__":
    main()
