"""Multi-host bring-up (parallel/mesh.py::maybe_initialize_distributed)."""

import os
from unittest import mock

import jax
import pytest

from smb_vision_tpu.parallel.mesh import maybe_initialize_distributed

_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


def _clean_env():
    return {k: v for k, v in os.environ.items() if k not in _VARS}


def test_auto_detect_negative():
    """Auto is a no-op without JAX_COORDINATOR_ADDRESS."""
    with mock.patch.dict(os.environ, _clean_env(), clear=True):
        assert maybe_initialize_distributed(None) is False
    assert maybe_initialize_distributed(False) is False


def test_auto_detect_positive_and_forced():
    """The coordinator, process count and id from the environment reach
    jax.distributed.initialize() as explicit arguments."""
    calls = []

    def fake_init(*a, **k):
        calls.append(k)

    with mock.patch.object(jax.distributed, "initialize", fake_init):
        with mock.patch.dict(os.environ, _clean_env(), clear=True):
            assert maybe_initialize_distributed(True) is False  # 1 process
            assert calls[-1] == {}
            os.environ.update(JAX_COORDINATOR_ADDRESS="localhost:1234",
                              JAX_NUM_PROCESSES="4", JAX_PROCESS_ID="2")
            maybe_initialize_distributed(None)
            assert calls[-1] == {"coordinator_address": "localhost:1234",
                                 "num_processes": 4, "process_id": 2}
    assert len(calls) == 2


def test_auto_degrades_when_no_coordinator():
    """Without JAX_COORDINATOR_ADDRESS auto mode stays single-process and
    never calls initialize(); forcing it surfaces initialize()'s error."""

    def fail_init(*a, **k):
        raise ValueError("coordinator_address should be defined.")

    with mock.patch.object(jax.distributed, "initialize", fail_init):
        with mock.patch.dict(os.environ, _clean_env(), clear=True):
            os.environ["JAX_NUM_PROCESSES"] = "2"
            assert maybe_initialize_distributed(None) is False
            with pytest.raises(ValueError, match="coordinator_address"):
                maybe_initialize_distributed(True)


def test_init_error_surfaces_when_coordinator_set():
    """With a coordinator in the environment, a failing initialize() is
    a configuration error and propagates (no silent single-process
    fallback)."""

    def fail_init(*a, **k):
        raise ValueError("coordinator unreachable")

    with mock.patch.object(jax.distributed, "initialize", fail_init):
        with mock.patch.dict(os.environ, _clean_env(), clear=True):
            os.environ["JAX_COORDINATOR_ADDRESS"] = "localhost:1"
            with pytest.raises(ValueError, match="unreachable"):
                maybe_initialize_distributed(None)


def test_double_init_is_noop():
    """A second init raises 'distributed.initialize should only be called
    once.' — the guard must swallow it (the promised 'safe to call twice'
    contract), not kill the run."""

    def second_init(*a, **k):
        raise RuntimeError("distributed.initialize should only be called "
                           "once.")

    with mock.patch.object(jax.distributed, "initialize", second_init):
        assert maybe_initialize_distributed(True) is False  # 1 process

    def other_error(*a, **k):
        raise RuntimeError("something actually broke")

    with mock.patch.object(jax.distributed, "initialize", other_error):
        try:
            maybe_initialize_distributed(True)
            raise AssertionError("unrelated RuntimeError swallowed")
        except RuntimeError as e:
            assert "actually broke" in str(e)


def test_local_batch_slice_is_per_process():
    """Per-PROCESS share: on a single-process 8-device mesh the whole
    global batch stays on this host (per-device slicing is GSPMD's job)."""
    import pytest

    from smb_vision_tpu.parallel.mesh import create_mesh, local_batch_slice

    mesh = create_mesh()
    assert local_batch_slice(16, mesh) == 16
    with pytest.raises(ValueError, match="divide"):
        # single process: any batch divides by 1 — fake a 3-process world
        class FakeDev:
            def __init__(self, p):
                self.process_index = p

        import numpy as np

        from jax.sharding import Mesh
        fake = mock.MagicMock()
        fake.devices.flat = [FakeDev(0), FakeDev(1), FakeDev(2)]
        local_batch_slice(16, fake)
