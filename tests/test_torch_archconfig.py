"""The port's copy of the architecture configs against the JAX package's:
every arch's published and reduced config equal field for field, the
same shape cells, and the same parameter counts."""
import dataclasses

import pytest

import repro.configs as J
import repro.configs.base as JB
import repro_torch.configs as P
import repro_torch.configs.base as PB

ARCHS = J.list_archs()


def test_registries_equal():
    assert P.list_archs() == ARCHS
    assert {k: dataclasses.asdict(v) for k, v in P.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J.SHAPES.items()}
    assert P.__all__ == J.__all__


@pytest.mark.parametrize("getter", ["get_config", "get_reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equal(arch, getter):
    j = getattr(J, getter)(arch)
    p = getattr(P, getter)(arch)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert p.resolved_head_dim == j.resolved_head_dim
    assert p.padded_vocab() == j.padded_vocab()
    assert p.padded_vocab(128) == j.padded_vocab(128)
    for active in (False, True):
        assert p.param_count(active) == j.param_count(active)
    assert [s.name for s in p.cells()] == [s.name for s in j.cells()]
    for name in J.SHAPES:
        assert p.model_flops(P.SHAPES[name]) == j.model_flops(J.SHAPES[name])


def test_shrink_and_unknown_arch():
    j = JB.shrink(J.get_config("rwkv6-1.6b"), n_layers=3)
    p = PB.shrink(P.get_config("rwkv6-1.6b"), n_layers=3)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    with pytest.raises(KeyError, match="nope"):
        P.get_config("nope")
