"""Does a column block of a bf16 product equal the same columns of the
whole product on the card?  Tensor-parallel serving (``repro_torch.dist.tp``)
computes each rank's column block of ``x @ w`` for its rows of the batch
and gathers the blocks; its tokens equal the one-rank engine's only where
those blocks are the one-rank product's bits.

    python3 scripts/tp_split_probe.py

For gemma3-1b's five projection shapes (K, N) and M rows (a 2 x 1024
prefill, a decode step of 4 and of 8 rows), counts the elements of
``x[rows] @ w[:, cols]`` (a rank's half of the rows and of the columns)
that differ from the whole product's, and of ``x[rows] @ w`` (the rows
alone); with cuBLAS's reduced-precision split-K reduction allowed
(PyTorch's default) and not.  Then the tied head at B = 4 and 2: the
partial logits over each half of d_model in f32, added and rounded once,
against the one-product bf16 logits.  Prints the card's name and power
limit first.  Needs a card; uses no part of the repo.
"""
import subprocess
import sys

import torch

SHAPES = [(1152, 1024), (1152, 256), (1152, 6912), (1024, 1152),
          (6912, 1152)]


def run(tag, g, dev):
    tot = 0
    for K, N in SHAPES:
        w = (0.02 * torch.randn(K, N, generator=g, device=dev)).bfloat16()
        for Mfull in (4096, 4, 8):
            x = torch.randn(Mfull, K, generator=g, device=dev).bfloat16()
            full = x @ w
            half = Mfull // 2
            bad = 0
            for r in range(2):
                xs = x[r * half:(r + 1) * half]
                for c in range(2):
                    ws = w[:, c * N // 2:(c + 1) * N // 2].contiguous()
                    y = xs @ ws
                    ref = full[r * half:(r + 1) * half,
                               c * N // 2:(c + 1) * N // 2]
                    bad += int((y != ref).sum())
            yb = x[:half] @ w
            badb = int((yb != full[:half]).sum())
            print(f"{tag} K={K} N={N} M={Mfull}: col+row split mismatches "
                  f"{bad} / {full.numel()}, row split only {badb}")
            tot += bad
    print(tag, "total", tot)


def main():
    print(sys.version, torch.__version__, torch.version.cuda)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    run("default", g, dev)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    run("no-reduced-reduction", g, dev)
    V, D = 262144, 1152
    t = (0.02 * torch.randn(V, D, generator=g, device=dev)).bfloat16()
    for B in (4, 2):
        h = torch.randn(B, 1, D, generator=g, device=dev).bfloat16()
        one = h @ t.T
        p = [h[..., i * 576:(i + 1) * 576].float()
             @ t[:, i * 576:(i + 1) * 576].float().T for i in range(2)]
        tp = (p[0] + p[1]).bfloat16()
        print("head B", B, "mismatch", int((tp != one).sum()), "of",
              one.numel(), "argmax equal",
              bool((tp.argmax(-1) == one.argmax(-1)).all()))


if __name__ == "__main__":
    main()
