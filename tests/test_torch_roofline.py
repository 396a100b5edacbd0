"""The port's ``launch/roofline`` against the JAX package's, on the CPU.

``collective_wire_bytes`` (on ``tests/test_roofline.py``'s HLO sample),
``extrapolate`` and ``model_flops`` (every arch x shape) give the
reference's numbers exactly: the functions are the same arithmetic.
``RooflineTerms`` differs only by its constants, the H100's, so its
seconds and its dominant term are checked against the card's peaks worked
by hand.
"""

import dataclasses

import pytest

from repro import configs as JC
from repro.configs import shapes as JS
from repro.launch import roofline as JR
from repro_torch import configs as C
from repro_torch.configs import shapes as S
from repro_torch.launch import roofline as R
from test_roofline import HLO_SAMPLE


@pytest.mark.parametrize("group", [1, 4, 16, 999])
def test_collective_wire_bytes_match_the_reference(group):
    assert R.collective_wire_bytes(HLO_SAMPLE, group) == \
        JR.collective_wire_bytes(HLO_SAMPLE, group)


def test_collective_wire_bytes_by_hand():
    wire = R.collective_wire_bytes(HLO_SAMPLE, 16)
    assert wire["all-gather"] == pytest.approx(16 * 4096 * 5120 * 2 * 15 / 16)
    assert wire["all-reduce"] == pytest.approx(
        2 * 16 * 256 * 5120 * 4 * 15 / 16)
    assert wire["reduce-scatter"] == pytest.approx(16 * 256 * 5120 * 2 * 15)
    assert wire["all-to-all"] == pytest.approx(16 * 256 * 128 * 2 * 3 / 4)
    assert wire["collective-permute"] == 8 * 128 * 4
    assert R.collective_wire_bytes("no collective here", 8) == dict.fromkeys(
        wire, 0.0)


@pytest.mark.parametrize("m1, m2, n", [(10.0, 12.0, 48), (3.5, 3.5, 7),
                                       (1e12, 1.7e12, 60), (2.0, 1.0, 1)])
def test_extrapolate_matches_the_reference(m1, m2, n):
    assert R.extrapolate(m1, m2, n) == JR.extrapolate(m1, m2, n)


@pytest.mark.parametrize("shape", list(JS.INPUT_SHAPES))
@pytest.mark.parametrize("arch", JC.ARCH_NAMES)
def test_model_flops_match_the_reference(arch, shape):
    for get, jget in ((C.get_full, JC.get_full),
                      (C.get_smoke, JC.get_smoke)):
        ours = R.model_flops(get(arch), S.INPUT_SHAPES[shape])
        assert ours == JR.model_flops(jget(arch), JS.INPUT_SHAPES[shape])
        assert ours > 0


def test_model_flops_count_active_params_and_kinds():
    cfg = C.get_full("olmoe-1b-7b")
    assert cfg.active_param_count() < cfg.param_count()
    train = S.INPUT_SHAPES["train_4k"]
    assert R.model_flops(cfg, train) == 6.0 * cfg.active_param_count() * (
        256 * 4096)
    decode = S.INPUT_SHAPES["decode_32k"]
    assert R.model_flops(cfg, decode) == 2.0 * cfg.active_param_count() * 128


def test_the_card_constants():
    assert R.PEAK_FLOPS == 989e12
    assert R.HBM_BW == 3.35e12
    assert R.NVLINK_BW == 450e9
    doc = R.__doc__
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in doc
    # no TPU v5e constant (197 TFLOP/s, 819 GB/s, 50 GB/s ICI) remains
    assert not hasattr(R, "ICI_BW")
    rates = {v for k, v in vars(R).items() if k.isupper()
             and isinstance(v, float)}
    assert rates == {989e12, 3.35e12, 450e9}
    assert {JR.PEAK_FLOPS, JR.HBM_BW, JR.ICI_BW}.isdisjoint(rates)


@pytest.mark.parametrize("flops, nbytes, wire, dominant", [
    (989e12, 3.35e12 * 2, 450e9 * 0.5, "memory"),
    (989e12 * 3, 3.35e12, 450e9, "compute"),
    (1e9, 1e9, 450e9 * 4, "collective")])
def test_terms_on_the_card_by_hand(flops, nbytes, wire, dominant):
    t = R.RooflineTerms(hlo_flops=flops, hlo_bytes=nbytes, wire_bytes=wire,
                        wire_by_kind={"all-reduce": wire},
                        model_flops=flops * 4 * 0.5, n_devices=4)
    assert t.compute_s == pytest.approx(flops / 989e12)
    assert t.memory_s == pytest.approx(nbytes / 3.35e12)
    assert t.collective_s == pytest.approx(wire / 450e9)
    assert t.dominant == dominant
    assert t.useful_flops_ratio == pytest.approx(0.5)
    d = t.as_dict()
    assert d["dominant"] == dominant and d["n_devices"] == 4
    assert d["compute_s"] == t.compute_s
    # the reference's fields, under the same keys
    ref = JR.RooflineTerms(**dataclasses.asdict(t)).as_dict()
    assert set(d) == set(ref)
    for k in ("hlo_flops_per_dev", "hlo_bytes_per_dev", "wire_bytes_per_dev",
              "model_flops", "useful_flops_ratio"):
        assert d[k] == ref[k]


def test_mfu_is_model_flops_over_the_peak():
    cfg = C.get_full("h2o-danube-1.8b")
    shape = S.InputShape("smoke_train", 4096, 2, "train")
    flops = 6.0 * cfg.param_count() * 2 * 4096
    assert R.mfu(cfg, shape, 1.5) == pytest.approx(flops / (1.5 * 989e12))
    empty = R.RooflineTerms(0.0, 0.0, 0.0, {}, 1.0, 1)
    assert empty.useful_flops_ratio == 0.0
