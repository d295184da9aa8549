"""What every cell of the benchmark shares: finding a cell's files by
name, drawing weights from the seed, the host clock, percentiles, the
reduction of a profiler trace to busy time, top device operations and
idle gaps, and the per-layer metric readers.

The benchmark is driven by data.  ``BENCHMARK.json`` names each cell's
configuration and traffic; everything else is found by name:

    perfbench/configs/<config>.json     sizes, dtype, cuts, deployment
    perfbench/reference/<config>.py     the plain float32 reference
    perfbench/traffic/<cell>.json       the traffic mix; its "kind" key
    perfbench/traffic/<kind>.py         names the generator, and
    perfbench/runners/<kind>.py         the runner that drives the port
    perfbench/metrics/<metric>.py       one reader per per-layer metric

Nothing here imports the JAX package or JAX.
"""
from __future__ import annotations

import importlib.util
import json
import math
import re
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent          # perfbench/
REPO = ROOT.parent

# NVIDIA's data sheet for one H100 SXM, dense: bf16 tensor-core rate and
# HBM bandwidth (the card's power limit is reported beside every run)
PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def manifest() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def load_json(*parts: str) -> dict:
    return json.loads(ROOT.joinpath(*parts).read_text())


def load_module(*parts: str):
    """A module of the benchmark by file path: names carry ``-`` and
    ``.``, so they are loaded by path, not imported by name."""
    path = ROOT.joinpath(*parts)
    name = "perfbench_" + re.sub(r"\W", "_", "_".join(parts))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str) -> tuple[dict, dict, dict, dict]:
    """(manifest, workload entry, configuration, traffic) of a cell."""
    man = manifest()
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{', '.join(work)}")
    w = work[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    cfg = json.loads((REPO / conf["file"]).read_text())
    cfg["name"] = conf["name"]
    traffic = load_json("traffic", f"{w['traffic']}.json")
    return man, w, cfg, traffic


def now() -> float:
    return time.perf_counter()


def correct(checks: dict) -> bool:
    """Every number compared is a number and at most its limit."""
    return all(v == v and v <= lim for v, lim in checks.values())


# ---------------------------------------------------------------------------
# weights from the seed
# ---------------------------------------------------------------------------

def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index``: every leaf has a stream of its
    own, so the reference can draw any leaf again alone."""
    return (seed * 1_000_003 + 7919 * (index + 1)) % (2 ** 63)


def is_norm(name: str) -> bool:
    return name.endswith(".scale")


def draw_leaf(name: str, shape, index: int, seed: int, dtype, device):
    """One weight: N(0, 0.02) for a matrix or a table, N(0, 0.1) for a
    norm's scale (the port's norms multiply by 1 + scale), drawn on the
    device in ``dtype`` in one call."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    t = torch.randn(tuple(shape), generator=gen, device=device, dtype=dtype)
    return t.mul_(0.1 if is_norm(name) else 0.02)


def draw_weights(specs: dict, seed: int, dtype, device) -> dict:
    """Every leaf of ``specs`` (name -> tensor or shape), in sorted order."""
    return {k: draw_leaf(k, getattr(v, "shape", v), i, seed, dtype, device)
            for i, (k, v) in enumerate(sorted(specs.items()))}


def leaf_index(specs: dict) -> dict:
    return {k: i for i, k in enumerate(sorted(specs))}


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the closest ranks (numpy's
    default), of a non-empty sequence."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of nothing")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ---------------------------------------------------------------------------
# device facts
# ---------------------------------------------------------------------------

def power_limit_w() -> float | None:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device_record(count: int = 1) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
            "power_limit_w": power_limit_w()}


# ---------------------------------------------------------------------------
# the profiler trace
# ---------------------------------------------------------------------------

class Trace:
    """A ``torch.profiler`` trace of the card's activity over a slice of
    the window, with the port's phase marks as host ranges: every
    :func:`repro_torch.trace.mark` inside the slice is stamped on the
    host's wall clock (the profiler's time base), so an idle gap on the
    device can be laid beside what the host was doing.  Host operations
    are not recorded: that would slow the host several times over and
    make the slice's idle share the profiler's."""

    def __init__(self):
        import torch
        self.torch = torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._orig = None
        self.stamps = []

    def _mark(self, name: str) -> None:
        self.stamps.append((name, time.time_ns()))
        self._orig(name)

    def __enter__(self):
        from repro_torch import trace
        self._orig = trace.mark
        trace.mark = self._mark
        self.prof.__enter__()
        self.stamps.append(("outside any mark", time.time_ns()))
        return self

    def __exit__(self, *exc):
        from repro_torch import trace
        self.stamps.append(("outside any mark", time.time_ns()))
        trace.mark = self._orig
        self.prof.__exit__(*exc)
        return False

    def events(self):
        """(kernels, ranges): device activities as (name, start_ns,
        end_ns), and the mark ranges on the host as (name, start_ns,
        end_ns), both sorted by start."""
        from torch.autograd import DeviceType
        dev = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            try:
                s, d = e.start_ns(), e.duration_ns()
            except AttributeError:
                s, d = e.start_us() * 1000, e.duration_us() * 1000
            dev.append((e.name(), s, s + d))
        dev.sort(key=lambda x: x[1])
        host = [(a, ta, tb) for (a, ta), (_, tb)
                in zip(self.stamps, self.stamps[1:])]
        return dev, host


def reduce_trace(dev, host, top: int = 10) -> dict:
    """Busy seconds (the union of device activity), the device operations
    that took most time, and the longest idle gaps between activities,
    each labelled by the host mark range open when the gap began."""
    busy = 0
    gaps = []
    end = None
    for _, s, e in dev:
        if end is None or s > end:
            if end is not None:
                gaps.append((s - end, end))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    by_name: dict[str, int] = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps.sort(key=lambda g: -g[0])
    labelled = []
    for length, at in gaps[:top]:
        label = "outside the slice"
        for name, s, e in host:
            if s <= at < e:
                label = name
            if s > at:
                break
        labelled.append([label, length / 1e9])
    return {"busy_s": busy / 1e9,
            "device_ops": [[n, t / 1e9] for n, t in ops],
            "idle_gaps": labelled}


_ATTN = re.compile(r"attn_kernel<.*,\s*(true|false)\s*>")


def kernel_family(name: str) -> str | None:
    """The port's kernel a device activity belongs to, by its symbol."""
    m = _ATTN.search(name)
    if m:
        return "paged_flash" if m.group(1) == "true" else "flash"
    for fam in ("combine_kernel", "fused_dsgd_kernel"):
        if fam in name:
            return fam[:-len("_kernel")]
    return None


def kernel_seconds(dev) -> dict:
    out: dict[str, float] = {}
    for name, s, e in dev:
        fam = kernel_family(name)
        if fam is not None:
            out[fam] = out.get(fam, 0.0) + (e - s) / 1e9
    return out


def roofline(ctx: dict, family: str, also=()) -> float | None:
    """The share (%) of the least time the card could take for a kernel
    family's work (its operations at the bf16 peak or its bytes at the
    HBM rate, whichever is longer, summed call by call) in the device
    time the family's launches took; ``also`` adds families whose launches
    serve the same calls (the split decode's combine).  None where the
    window ran none of it."""
    secs = sum(ctx["kernel_s"].get(f, 0.0) for f in (family,) + tuple(also))
    work = ctx["work"].get(family)
    if not secs or not work:
        return None
    least = sum(max(f / PEAK_FLOPS_BF16, b / HBM_BYTES_PER_S)
                for f, b in work)
    return 100.0 * least / secs


def read_metrics(names, ctx: dict) -> dict:
    """Each per-layer metric's reader (``metrics/<name>.py``, ``read(ctx)
    -> value or None``); a reader that finds nothing leaves its metric
    out."""
    units = {m["name"]: m["unit"] for m in manifest()["per_layer"]}
    out = {}
    for name in names:
        value = load_module("metrics", f"{name}.py").read(ctx)
        if value is not None:
            out[name] = {"value": float(value), "unit": units[name]}
    return out


def mark_spans(marks) -> list[tuple[str, float]]:
    """(name, ms to the next mark) of a ``cuda_marks`` list, in order; the
    last mark has no span."""
    return [(a, ea.elapsed_time(eb))
            for (a, ea), (_, eb) in zip(marks, marks[1:])]


# ---------------------------------------------------------------------------
# the port's configuration, built from a configuration file
# ---------------------------------------------------------------------------

# configuration-file key -> (the port's ArchConfig field, sub-config)
_FIELDS = {
    "d_model": ("d_model", None), "num_heads": ("num_heads", None),
    "num_kv_heads": ("num_kv_heads", None), "head_dim": ("head_dim", None),
    "d_ff": ("d_ff", None), "vocab_size": ("vocab_size", None),
    "decoder_layers": ("num_blocks", None),
    "num_hidden_layers": ("num_blocks", None),
    "encoder_layers": ("num_layers", "encoder"),
    "encoder_d_ff": ("d_ff", "encoder"),
    "num_experts": ("num_experts", "moe"), "top_k": ("top_k", "moe"),
    "d_expert": ("d_expert", "moe"),
    "capacity_factor": ("capacity_factor", "moe"),
    "attn_softcap": ("attn_softcap", None),
    "final_softcap": ("final_softcap", None),
    "mlp_act": ("mlp_act", None), "tie_embeddings": ("tie_embeddings", None),
}


def port_config(c: dict):
    """The port's ``ArchConfig`` of ``c["arch"]`` with the file's sizes.
    A size the file keeps from its source (not under ``reduced``) has to
    be the port's own already: a port whose configuration drifted from
    the published one raises here rather than be measured."""
    import dataclasses
    from repro_torch.configs import get_config
    base = get_config(c["arch"])
    top, subs = {}, {}
    for key, (field, sub) in _FIELDS.items():
        if key not in c:
            continue
        have = getattr(base if sub is None else getattr(base, sub), field)
        if have != c[key] and key not in c.get("reduced", ()):
            raise SystemExit(f"{c['arch']}: the port's {field} is {have!r}, "
                             f"the configuration file's {key} {c[key]!r}")
        (top if sub is None else subs.setdefault(sub, {}))[field] = c[key]
    for sub, fields in subs.items():
        top[sub] = dataclasses.replace(getattr(base, sub), **fields)
    return dataclasses.replace(base, **top)
