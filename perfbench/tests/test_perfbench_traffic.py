"""The traffic generators repeat exactly for a seed, and every seed gets
the same work in another order."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import lib
from perfbench.tests import cases

SERVE = lib.load_module("traffic", "serve.py")
TRAIN = lib.load_module("traffic", "train.py")


@pytest.mark.parametrize("cell", ["grok-chat", "grok-longprompt"])
def test_serve_requests_repeat_and_share_their_sizes(cell):
    t = lib.load_json("traffic", f"{cell}.json")
    seed = 2 ** 33 + 17
    a = SERVE.requests(t, 131072, seed, 64)
    assert a == SERVE.requests(t, 131072, seed, 64)
    b = SERVE.requests(t, 131072, seed + 1, 64)
    assert a != b
    assert sorted(len(x) for x, _ in a) == sorted(len(x) for x, _ in b)
    assert [s for _, s in a] == [s for _, s in b]
    assert [x for x, _ in a] != [x for x, _ in b]
    lo, hi = t["prompt"]["min"], t["prompt"]["max"]
    assert all(lo <= len(x) <= hi for x, _ in a)
    assert all(len(x) <= max(t["buckets"]) for x, _ in a)


def test_lognormal_quantiles_keep_their_median():
    spec = {"dist": "lognormal", "median": 256, "sigma": 0.8, "min": 64,
            "max": 1024}
    lengths = SERVE.prompt_lengths(spec, 401)
    assert lengths[200] == 256 and lengths == sorted(lengths)
    assert SERVE._normal_ppf(0.975) == pytest.approx(1.959964, abs=1e-6)


def test_train_batches_repeat_and_differ_by_row():
    t = cases.train_traffic()
    a = TRAIN.batches(cases.SEAMLESS, t, 2 ** 31 + 3, "cpu")
    b = TRAIN.batches(cases.SEAMLESS, t, 2 ** 31 + 3, "cpu")
    x, y = a(1), b(1)
    np.testing.assert_array_equal(x["tokens"], y["tokens"])
    assert torch.equal(x["frames"], y["frames"])
    assert x["frames"].dtype == torch.bfloat16
    toks = x["tokens"].reshape(-1, t["seq_len"])
    assert len({tuple(r) for r in toks}) == toks.shape[0]
    np.testing.assert_array_equal(x["labels"][..., :-1], x["tokens"][..., 1:])
    assert (x["labels"][..., -1] == -100).all()
    assert not np.array_equal(a(2)["tokens"], x["tokens"])
