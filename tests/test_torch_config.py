"""The port's copies of the arch configs equal the JAX package's, field by
field, for all ten archs, FULL and SMOKE."""

import dataclasses

import pytest

from repro.configs import ARCH_NAMES, get_config
from repro_torch.configs import ARCH_NAMES as TORCH_ARCH_NAMES
from repro_torch.configs import get_config as torch_get_config


def test_arch_names_match():
    assert TORCH_ARCH_NAMES == ARCH_NAMES


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_run_config_matches_reference(arch, smoke):
    want = get_config(arch, smoke=smoke)
    got = torch_get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.model.param_count() == want.model.param_count()
    assert got.model.resolved_head_dim == want.model.resolved_head_dim


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        torch_get_config("no-such-arch")
