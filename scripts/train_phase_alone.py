#!/usr/bin/env python3
"""``chip_smoke.py``'s ``[train]`` phase alone, in a fresh process, on one
CUDA card: the kernels' build, then full-width gemma3-1b DSGD-momentum
training (n = 3, Base-2, 6 timed steps) with its checks, launch counts
and split, and the host time of the grouped update.

    python3 scripts/train_phase_alone.py

Inside ``chip_smoke.py`` the same phase runs after the serving phases in
one long-lived process; run alone, its step shows what the port's host
path costs without what those phases leave behind.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_phase_alone: no CUDA device")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    cs.phase_build(torch)
    cs.phase_train(torch, dev, card)


if __name__ == "__main__":
    main()
