#!/usr/bin/env python3
"""``chip_smoke.py``'s ``[build]``, ``[tp-serve]`` + ``[tp-train]`` +
``[tp-spec]``, ``[dryrun]``, ``[smoke-mp]`` and ``[examples]`` phases
alone, on one card (the tensor-parallel paths and the tools without the
rest of the script's ~15 minutes):

    python3 scripts/tp_phases.py
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as C  # noqa: E402


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("tp_phases: no CUDA device")
    dev = torch.device("cuda", 0)
    card = C.card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    C.phase_build(torch)
    print(f"[seconds] [build] {time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    launches, _, counted = C.phase_tp_serve(torch, dev, card)
    print(f"[tp-spec] flash launches per rank: {launches['tp-spec']}")
    print(f"[seconds] [tp-serve] [tp-train] [tp-spec] "
          f"{time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    C.phase_tools(card, counted, C.start_dry_sweep())
    print(f"[seconds] [dryrun] [smoke-mp] [examples] "
          f"{time.perf_counter() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main()
