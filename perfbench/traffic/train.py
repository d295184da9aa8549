"""The generator of training traffic: each node's batch of every step,
drawn from the seed.

A traffic file of kind ``train`` gives ``nodes``, ``seqs_per_node``,
``seq_len`` (target tokens a sequence) and, for an encoder-decoder,
``frames`` (stub source frames a sequence).  Token ids are uniform over
the vocabulary, so every row of every step differs; the labels are the
next tokens, the last position unlabelled (-100).  The frames are
N(0, 1) x 0.02, drawn on the device in bfloat16, as the stub audio
front end emits them.  The same (seed, step) gives the same batch.
"""
from __future__ import annotations

import numpy as np


def batches(config: dict, traffic: dict, seed: int, device):
    """``batch(step)``: a dict of (nodes, seqs, ...) arrays: ``tokens``,
    ``labels`` (numpy int64) and ``frames`` (a bfloat16 tensor on
    ``device``) where the configuration has an encoder."""
    import torch
    n, b, t = traffic["nodes"], traffic["seqs_per_node"], traffic["seq_len"]
    vocab = config["vocab_size"]

    def batch(step: int) -> dict:
        rng = np.random.default_rng([seed, step])
        toks = rng.integers(0, vocab, size=(n, b, t + 1))
        labels = toks[..., 1:].copy()
        labels[..., -1] = -100
        out = {"tokens": toks[..., :-1], "labels": labels}
        if traffic.get("frames"):
            gen = torch.Generator(device=device)
            gen.manual_seed(int(rng.integers(0, 2 ** 62)))
            out["frames"] = (torch.randn(
                (n, b, traffic["frames"], config["d_model"]), generator=gen,
                device=device, dtype=torch.float32) * 0.02).to(torch.bfloat16)
        return out

    return batch
