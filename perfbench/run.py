"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card it is started on: set-up
(weights from the seed, warm-up of the cell's own shapes), a window of
``--seconds``, then the check of what the window produced against the
plain float32 reference.  With ``--trace 0`` the result carries the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, read
from the port's phase marks and a ``torch.profiler`` trace of the window,
and a breakdown of device time.  The last line of standard output is one
JSON object; the last lines of standard error name each number compared
with its limit.  Without a CUDA card, or with fewer cards than the cell
asks for, it exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _env() -> None:
    """Kernel caches inside the checkout, at fixed paths, so that only a
    cell's first run in a checkout builds."""
    cache = REPO / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (str(REPO / "src"), str(REPO)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` of JAX, flax or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    if not (REPO / "src" / "repro_torch").is_dir():
        print("the port (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 3
    from perfbench import lib
    man, work, config, traffic = lib.cell(args.workload)

    import torch
    # one process with few threads: the host's other work stays off the
    # cores that feed the card
    torch.set_num_threads(4)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < work["chips"]:
        print(f"{args.workload} needs {work['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    per_layer = [m["name"] for m in man["per_layer"]
                 if args.workload in m.get("workloads", [args.workload])]
    runner = lib.load_module("runners", f"{traffic['kind']}.py")
    res = runner.run(config=config, traffic=traffic, seed=args.seed,
                     seconds=args.seconds, trace=bool(args.trace),
                     per_layer=per_layer, t_start=T_START)

    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures "
              f"the port alone", file=sys.stderr)
        return 4

    if args.trace:
        metrics = res["per_layer"]
    else:
        units = {m["name"]: m["unit"] for m in man["end_to_end"]
                 if args.workload in m.get("workloads", [args.workload])}
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in res["metrics"].items() if k in units}
    checks = res["checks"]
    correct = lib.correct(checks)
    device = dict(res["device"])
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["traced_s"])
    print(f"window {res['window_s']:.3f} s, {res['steps']} steps; "
          f"reference {res['reference_s']:.1f} s", file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
