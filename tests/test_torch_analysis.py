"""The analytic FLOP model (``repro_torch.analysis.flops``) against the
reference's (``repro.analysis.flops``): every term of ``forward_flops``
and ``train_flops`` (remat on and off, trip counts on and off),
``model_flops`` and ``param_counts`` for all 10 archs of the registry at
the four assigned input shapes and one decode length.  The floats agree
to rel 1e-12 and the parameter counts exactly; the port counts the
parameters of a ``Model`` on the meta device, the reference those of
``jax.eval_shape`` of its init.  The reference's own checks
(``tests/test_analysis.py``) are repeated against the port."""
import pytest

from repro.analysis import flops as JF
from repro.configs import get_config as jget
from repro_torch.analysis import flops as F
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch.shapes import (INPUT_SHAPES, config_for_shape,
                                       skip_reason, text_len)
from repro_torch.models.frontends import AUDIO_FRAMES

REL = 1e-12
DECODE_S = 1024


@pytest.fixture(autouse=True, scope="module")
def _reference_counts_once():
    """The reference's ``model_flops`` traces the model's init for its
    parameter count at every call; count each arch once."""
    counts = {}
    real = JF.param_counts

    def once(cfg):
        if cfg not in counts:
            counts[cfg] = real(cfg)
        return dict(counts[cfg])

    JF.param_counts = once
    yield
    JF.param_counts = real


def _close(got, want):
    assert abs(got - want) <= REL * abs(want), (got, want)


def _same_cost(got, want):
    assert list(got.notes) == list(want.notes)
    for k in want.notes:
        _close(got.notes[k], want.notes[k])
    _close(got.flops, want.flops)


def _pairs(arch, shape):
    cfg, jcfg = get_config(arch), jget(arch)
    if shape != "decode" and skip_reason(cfg, shape):
        pytest.skip(f"{arch} skips {shape}")
    if shape == "long_500k":
        cfg = config_for_shape(cfg, shape)
        jcfg = jcfg.long_context_variant()
    return cfg, jcfg


def _calls(cfg, shape):
    """(function name, kwargs) of each count the dry run takes for the
    shape."""
    enc = float(AUDIO_FRAMES) if cfg.encoder is not None else 0.0
    if shape == "decode":
        return [("forward_flops", dict(batch=4, T=1, S=DECODE_S,
                                       decode=True)),
                ("model_flops", dict(kind="decode", global_batch=4,
                                     seq=DECODE_S))]
    info = INPUT_SHAPES[shape]
    B, S = info["global_batch"], info["seq"]
    t = text_len(cfg, S)
    if info["kind"] == "train":
        out = [("train_flops", dict(global_batch=B, seq=S, remat=r,
                                    trip_counts=tc, enc_T=enc, text_T=t))
               for r in (True, False) for tc in (True, False)]
    elif info["kind"] == "prefill":
        out = [("forward_flops", dict(batch=B, T=t, enc_T=enc,
                                      trip_counts=tc))
               for tc in (True, False)]
    else:
        out = [("forward_flops", dict(batch=B, T=1, S=S, decode=True,
                                      trip_counts=tc))
               for tc in (True, False)]
    return out + [("model_flops", dict(kind=info["kind"], global_batch=B,
                                       seq=S, text_T=t))]


@pytest.mark.parametrize("shape", list(INPUT_SHAPES) + ["decode"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_costs_equal_reference(arch, shape):
    cfg, jcfg = _pairs(arch, shape)
    for name, kw in _calls(cfg, shape):
        got = getattr(F, name)(cfg, **kw)
        want = getattr(JF, name)(jcfg, **kw)
        if name == "model_flops":
            _close(got, want)
        else:
            _same_cost(got, want)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_counts_equal_reference(arch):
    assert F.param_counts(get_config(arch)) == \
        JF.param_counts(jget(arch))


def test_param_counts_match_model_cards():
    expect_total = {  # billions, +-6%
        "deepseek-v3-671b": 671, "grok-1-314b": 314,
        "jamba-1.5-large-398b": 398, "llava-next-34b": 34.4,
        "granite-8b": 8.1, "qwen1.5-4b": 3.8, "gemma2-2b": 2.6,
        "mamba2-2.7b": 2.7, "gemma3-1b": 1.0,
    }
    for arch, bn in expect_total.items():
        total = F.param_counts(get_config(arch))["total"] / 1e9
        assert abs(total - bn) / bn < 0.07, (arch, total)
    assert abs(F.param_counts(get_config("deepseek-v3-671b"))["active"]
               / 1e9 - 37) < 2.5
    assert abs(F.param_counts(get_config("jamba-1.5-large-398b"))["active"]
               / 1e9 - 94) < 4


def test_train_flops_ge_forward():
    cfg = get_config("granite-8b")
    f = F.forward_flops(cfg, batch=8, T=1024).flops
    t = F.train_flops(cfg, global_batch=8, seq=1024, remat=False).flops
    tr = F.train_flops(cfg, global_batch=8, seq=1024, remat=True).flops
    assert t == pytest.approx(3 * f, rel=1e-6)
    assert tr > t


def test_model_flops_brackets_analytic():
    cfg = get_config("granite-8b")
    ana = F.train_flops(cfg, global_batch=256, seq=4096, remat=False).flops
    mf = F.model_flops(cfg, kind="train", global_batch=256, seq=4096)
    assert 0.5 < mf / ana < 2.0


def test_trip_counts_scale_with_blocks():
    cfg = get_config("granite-8b")
    full = F.forward_flops(cfg, batch=1, T=128, trip_counts=True).flops
    one = F.forward_flops(cfg, batch=1, T=128, trip_counts=False).flops
    assert full > one * (cfg.num_blocks - 1) / 2


def test_decode_flops_linear_in_cache():
    cfg = get_config("granite-8b")
    f1 = F.forward_flops(cfg, batch=4, T=1, S=1024, decode=True).flops
    f2 = F.forward_flops(cfg, batch=4, T=1, S=2048, decode=True).flops
    assert f2 > f1
