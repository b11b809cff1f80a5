"""The port's GPU config against the JAX package's: the same constants and
config values, the same split into static and dynamic halves, and the same
errors, naming the same key."""
import dataclasses

import numpy as np
import pytest

import repro.sim.config as J
import repro_torch.sim.config as P
from repro_torch.convert import dyn_to_numpy, dyn_to_torch


@pytest.mark.parametrize("name", [
    "FP32", "INT32", "SFU", "TENSOR", "LDG", "STG", "BAR", "N_CLASSES",
    "CLASS_NAMES", "N_UNITS", "UNIT_OF_CLASS", "LATENCY_OF_CLASS",
    "DISPATCH_OF_CLASS", "SCHEDULERS", "DYNAMIC_FIELDS", "TABLE_FIELDS",
    "DYN_KEYS"])
def test_constants_equal(name):
    assert getattr(P, name) == getattr(J, name)


@pytest.mark.parametrize("cfg", ["TINY", "RTX3080TI"])
def test_configs_equal(cfg):
    assert dataclasses.asdict(getattr(P, cfg)) == \
        dataclasses.asdict(getattr(J, cfg))
    assert dataclasses.asdict(P.static_part(getattr(P, cfg))) == \
        dataclasses.asdict(J.static_part(getattr(J, cfg)))


@pytest.mark.parametrize("overrides", [
    None, {"sched": 1}, {"l2_lat": 64, "icnt_lat": 20},
    {"lat": (1, 2, 3, 4, 5, 6, 7)}])
def test_split_config_equal(overrides):
    _, jd = J.split_config(J.TINY, overrides)
    _, pd = P.split_config(P.TINY, overrides, device="cpu")
    flat = dyn_to_numpy(pd)
    for k, v in jd.flat().items():
        assert np.array_equal(np.asarray(v), flat[k]), k
        assert flat[k].dtype == np.int32


def test_dyn_roundtrip_through_convert():
    _, jd = J.split_config(J.RTX3080TI, {"sched": 1})
    pd = dyn_to_torch({k: np.asarray(v) for k, v in jd.flat().items()},
                      "cpu")
    back = J.DynConfig.from_flat(dyn_to_numpy(pd))
    for k, v in jd.flat().items():
        assert np.array_equal(np.asarray(v), np.asarray(back.flat()[k]))
    assert P.DynConfig.from_flat(pd.flat(), "cpu").flat().keys() == \
        pd.flat().keys()


def _full_dict(**changes):
    src = {k: getattr(J.TINY, k) for k in J.DYNAMIC_FIELDS}
    src.update(sched=0, lat=J.LATENCY_OF_CLASS, disp=J.DISPATCH_OF_CLASS)
    src.update(changes)
    return src


ERROR_CASES = {
    "unknown key": (False, {"bogus": 3}),
    "unknown table key": (False, {"lat_table": (1,) * 7}),
    "short lat": (False, {"lat": (1, 2, 3)}),
    "long disp": (False, {"disp": (1,) * 9}),
    "icnt below quantum": (False, {"icnt_lat": 8}),
    "static missing keys": (True, {"l2_lat": 5}),
    "static complete, short disp": (True, _full_dict(disp=(1, 1))),
    "static complete, icnt below quantum": (True, _full_dict(icnt_lat=4)),
    "static alone": (True, None),
}


def _error(split, cfg, overrides, **kw):
    with pytest.raises(ValueError) as exc:
        split(cfg, overrides, **kw)
    return str(exc.value)


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_split_config_errors_name_the_same_key(case):
    static, overrides = ERROR_CASES[case]
    jcfg = J.static_part(J.TINY) if static else J.TINY
    pcfg = P.static_part(P.TINY) if static else P.TINY
    assert _error(P.split_config, pcfg, overrides, device="cpu") == \
        _error(J.split_config, jcfg, overrides)


def test_check_dyn_errors_match():
    jflat = {k: np.asarray(v) for k, v in
             J.split_config(J.TINY)[1].flat().items()}
    for bad in ({"icnt_lat": np.int32(4)}, {"lat": np.ones(5, np.int32)}):
        flat = dict(jflat, **bad)
        with pytest.raises(ValueError) as je:
            J.check_dyn(J.static_part(J.TINY), J.DynConfig.from_flat(flat),
                        lane="lane 3")
        with pytest.raises(ValueError) as pe:
            P.check_dyn(P.static_part(P.TINY),
                        P.DynConfig.from_flat(flat, "cpu"), lane="lane 3")
        assert str(pe.value) == str(je.value)


def test_telemetry_config_splits_as_reference():
    kw = dict(telemetry_samples=4, telemetry_every=3)
    got, _ = P.split_config(dataclasses.replace(P.TINY, **kw), device="cpu")
    want, _ = J.split_config(dataclasses.replace(J.TINY, **kw))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError, match="telemetry_every=0 must be ≥ 1"):
        dataclasses.replace(P.TINY, telemetry_every=0)

