"""The port keeps its own copy of the configuration tree
(vstar_tpu_torch/core/config.py); every preset must stay field for field
equal to the JAX package's, so the copy cannot drift."""

import dataclasses

import pytest

from vstar_tpu.core import config as jcfg
from vstar_tpu_torch.core import config as tcfg


@pytest.mark.parametrize("factory", ["vqa_llm_7b", "vsm_7b", "vqa_llm_13b",
                                     "vsm_13b", "vqa_llm_tiny", "vsm_tiny",
                                     "_tiny_llama"])
def test_presets_match_jax(factory):
    got = getattr(tcfg, factory)()
    want = getattr(jcfg, factory)()
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_same_config_classes_and_fields():
    names = sorted(n for n, v in vars(jcfg).items()
                   if dataclasses.is_dataclass(v) and isinstance(v, type))
    assert names == sorted(n for n, v in vars(tcfg).items()
                           if dataclasses.is_dataclass(v)
                           and isinstance(v, type))
    for n in names:
        assert [f.name for f in dataclasses.fields(getattr(tcfg, n))] == \
            [f.name for f in dataclasses.fields(getattr(jcfg, n))]
        assert dataclasses.asdict(getattr(tcfg, n)()) == \
            dataclasses.asdict(getattr(jcfg, n)())
