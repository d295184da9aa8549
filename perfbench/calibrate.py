"""Readings that set the limits of ``correct``, on the card, in one
process: for each seed, a short run of the cell and its numbers; with
``--control`` also the control's (the reference in float8 e4m3 put in the
program's place, on the same inputs); with ``--fault`` the numbers of a
run with the timed path broken underneath (training: ``unchanged``,
``half_batch``, ``no_mix``; serving: ``token``, ``half_batch``,
``slot``, ``kv_write``); with ``--witness`` (training) the program's
other path, the mix as a callable.  The benchmark's own runs never run
these.  A cell that ``BENCHMARK.json`` does not hold is named by its
files: ``--workload <traffic> --config <config>``.

    python3 perfbench/calibrate.py --workload grok-chat --seeds 1 2 3 \
        --seconds 5 --control [--fault token]

Prints one JSON line per run.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--config", help="configuration of a cell that "
                    "BENCHMARK.json does not hold")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--no-sound", action="store_true",
                    help="run only the faults")
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--set", action="append", default=[],
                    help="key=JSON value of the traffic file to try")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import torch
    from perfbench import lib
    if args.config:
        config = json.loads((lib.ROOT / "configs"
                             / f"{args.config}.json").read_text())
        config["name"] = args.config
        traffic = lib.load_json("traffic", f"{args.workload}.json")
    else:
        _, _, config, traffic = lib.cell(args.workload)
    for kv in args.set:
        key, value = kv.split("=", 1)
        traffic[key] = json.loads(value)
    runner = lib.load_module("runners", f"{traffic['kind']}.py")
    for seed in args.seeds:
        for fault in ([] if args.no_sound else [None]) + args.fault:
            extra = {"witness": True} if args.witness else {}
            res = runner.run(config=config, traffic=traffic, seed=seed,
                             seconds=args.seconds, trace=False, fault=fault,
                             controls=args.control and fault is None,
                             **extra)
            print(json.dumps({
                "workload": args.workload, "seed": seed, "fault": fault,
                "witness": args.witness, "steps": res["steps"],
                "set": args.set, "readings": res["readings"],
                "control": res.get("control"), "metrics": res["metrics"],
                "reference_s": res["reference_s"],
                "peak": res["device"]["memory_peak_bytes"]}), flush=True)
            del res
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
