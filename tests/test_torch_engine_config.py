"""The port's `EngineConfig`, the reference's deprecated shim over
`ServeConfig` (`src/repro/serving/engine.py`): the same signature and
docstring, `ServeConfig.for_engine` with `chunk_size` mapped to
`max_prefill_tokens`, field for field equal to the reference's."""
import dataclasses
import inspect

import pytest

from repro.serving import engine as jengine
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.scheduler import ServeConfig


def test_engine_config_shim_returns_serve_config():
    """As `tests/test_session.py::test_config_shims_return_serve_config`
    holds the reference's."""
    e = EngineConfig(chunk_size=24, num_device_blocks=40)
    assert isinstance(e, ServeConfig)
    assert e.max_prefill_tokens == 24 and e.num_device_blocks == 40
    assert EngineConfig().num_device_blocks == 128      # old engine default
    assert EngineConfig() == ServeConfig.for_engine()
    assert EngineConfig(chunk_size=24) == \
        ServeConfig.for_engine(max_prefill_tokens=24)


@pytest.mark.parametrize("kw", [
    {}, {"chunk_size": 24, "num_device_blocks": 40},
    {"policy": "vllm", "chunked": True, "fused": True, "chunk_size": 64},
    {"max_prefill_tokens": 16, "block_size": 8, "num_host_blocks": 512}])
def test_engine_config_equals_the_reference(kw):
    got = dataclasses.asdict(EngineConfig(**kw))
    want = dataclasses.asdict(jengine.EngineConfig(**kw))
    assert got == want


def test_engine_config_signature_and_docstring():
    assert inspect.signature(EngineConfig).parameters.keys() == \
        inspect.signature(jengine.EngineConfig).parameters.keys()
    assert EngineConfig.__doc__ == jengine.EngineConfig.__doc__
