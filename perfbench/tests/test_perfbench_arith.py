"""The yardstick's arithmetic against values worked out by hand, and the
frozen Base-(k+1) matrices against the port's."""
from __future__ import annotations

import numpy as np
import pytest

from perfbench import arith, lib
from perfbench.tests import cases

P = lib.load_module("reference", "_plain.py")


def test_attention_scores_causal_half():
    assert arith.attn_scores(2, 8, 4, 4, causal=False) == 4 * 2 * 8 * 16
    assert arith.attn_scores(2, 8, 4, 4, causal=True) == 4 * 2 * 8 * 10
    assert arith.attn_scores(1, 1, 2, 6, causal=True) == 4 * 12


def test_flash_and_paged_work():
    ops, nbytes = arith.flash_work(batch=1, heads=4, kv_heads=2, hd=8, tq=3,
                                   s=5, causal=False)
    assert ops == 4 * 4 * 8 * 15
    assert nbytes == 2 * 8 * (2 * 3 * 4 + 2 * 5 * 2)
    ops, nbytes = arith.paged_decode_work(lengths=[3, 1], heads=4,
                                          kv_heads=2, hd=8)
    assert ops == 4 * 4 * 8 * 4
    assert nbytes == 2 * 8 * (2 * 2 * 4 + 2 * 4 * 2)


def test_fused_dsgd_bytes():
    assert arith.fused_dsgd_work([(10, 2, 2, 2)]) == (40, 10 * 10)
    assert arith.fused_dsgd_work([(3, 4, 4, 2), (1, 2, 2, 2)]) \
        == (16, 3 * 18 + 10)


def test_decoder_token_and_prefill_flops():
    c = dict(cases.GROK, num_hidden_layers=1, vocab_size=10)
    D, H, KV, hd, E, F = 1024, 4, 2, 16, 4, 96
    proj = 2 * D * (2 * H + 2 * KV) * hd
    moe = 2 * D * E + 6 * 2 * D * F
    assert arith.decoder_token_flops(c, 5) == \
        proj + 4 * H * hd * 5 + moe + 2 * D * 10
    assert arith.prefill_flops(c, 3) == \
        3 * proj + 4 * H * hd * 6 + 3 * moe + 2 * D * 10


def test_train_step_flops_by_hand():
    c = cases.SEAMLESS
    D, H, hd, F, Fe, V = 64, 4, 16, 128, 96, 512
    b, t, f = 2, 8, 4
    proj = 2 * D * (4 * H) * hd
    enc = b * f * proj + b * 4 * H * hd * f * f + 6 * b * f * D * Fe
    cross = 2 * b * t * D * H * hd * 2 + 2 * b * f * D * 2 * H * hd \
        + b * 4 * H * hd * t * f
    dec = b * t * proj + b * 4 * H * hd * t * (t + 1) / 2 + cross \
        + 6 * b * t * D * F
    want = 3 * 3 * (2 * enc + 2 * dec + 2 * b * t * D * V)
    got = arith.train_step_flops(c, nodes=3, batch=b, seq=t, frames=f)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("n,k", [(3, 1), (4, 1), (5, 1), (6, 2), (12, 2)])
def test_base_matrices_equal_the_port(n, k):
    from repro_torch.topology import TopologySpec, build_schedule
    sched = build_schedule(TopologySpec(name="base", n=n, k=k))
    mats = P.base_matrices(n, k)
    assert len(mats) == len(sched)
    for r, W in enumerate(mats):
        np.testing.assert_allclose(W.numpy(), np.asarray(sched.W(r)),
                                   atol=1e-15)
    prod = np.eye(n)
    for W in mats:
        prod = W.numpy() @ prod
    np.testing.assert_allclose(prod, np.full((n, n), 1.0 / n), atol=1e-12)


def test_percentile_matches_numpy():
    xs = [5.0, 1.0, 3.5, 9.0, 2.25, 7.0]
    for q in (0, 50, 95, 100):
        assert lib.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
