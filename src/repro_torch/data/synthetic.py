"""Synthetic data pipelines (the port's numpy copy of
``repro/data/synthetic.py``: the same seed gives the reference's data
bit for bit).

1. ``dirichlet_classification`` — the paper's Sec. 6.2 heterogeneity
   substrate: a C-class Gaussian-mixture classification problem whose
   per-node class proportions are drawn from Dirichlet(alpha) [Hsu et al.
   2019], exactly the protocol the paper uses to shard CIFAR.  alpha -> 0
   gives one-class nodes (maximum heterogeneity), alpha -> inf IID nodes.

2. ``token_batches`` — deterministic synthetic LM token stream for the
   model-zoo training paths (shards by node/data axis).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class HeteroDataset:
    """Per-node training data + shared test set."""
    node_x: np.ndarray      # (n_nodes, per_node, dim)
    node_y: np.ndarray      # (n_nodes, per_node)
    test_x: np.ndarray
    test_y: np.ndarray
    alpha: float


def dirichlet_classification(n_nodes: int, per_node: int, *, dim: int = 64,
                             num_classes: int = 10, alpha: float = 0.1,
                             test_size: int = 2048, margin: float = 2.0,
                             seed: int = 0) -> HeteroDataset:
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((num_classes, dim)) * margin
    # per-node class proportions ~ Dirichlet(alpha)
    props = rng.dirichlet([alpha] * num_classes, size=n_nodes)
    node_x = np.empty((n_nodes, per_node, dim), np.float32)
    node_y = np.empty((n_nodes, per_node), np.int32)
    for i in range(n_nodes):
        ys = rng.choice(num_classes, size=per_node, p=props[i])
        node_x[i] = means[ys] + rng.standard_normal((per_node, dim))
        node_y[i] = ys
    ty = rng.integers(0, num_classes, size=test_size)
    tx = means[ty] + rng.standard_normal((test_size, dim))
    return HeteroDataset(node_x, node_y, tx.astype(np.float32),
                         ty.astype(np.int32), alpha)


def token_batches(step: int, *, batch: int, seq: int, vocab: int,
                  seed: int = 0, noise: float = 0.05) -> dict:
    """Deterministic synthetic LM batch with learnable structure: each row
    follows t_{i+1} = (t_i + stride) mod vocab for a per-row stride drawn
    from a small set, with ``noise`` fraction of corrupted positions — so
    next-token loss is reducible (a model that learns the stride rule
    beats the unigram floor)."""
    rng = np.random.default_rng(seed + step)
    start = rng.integers(0, vocab, size=(batch, 1))
    stride = rng.choice([1, 2, 3, 5, 7], size=(batch, 1))
    toks = (start + stride * np.arange(seq)[None, :]) % vocab
    corrupt = rng.random((batch, seq)) < noise
    toks = np.where(corrupt, rng.integers(0, vocab, size=(batch, seq)),
                    toks).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    return {"tokens": toks, "labels": labels}
