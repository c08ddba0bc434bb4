"""Train-state checkpoint files (train/checkpoint.py)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smb_vision_tpu.train.checkpoint import CheckpointManager


def _state(seed=0):
    r = np.random.default_rng(seed)
    return {
        "params": {"w": jnp.asarray(r.normal(size=(3, 4)), jnp.float32),
                   "h": jnp.asarray(r.normal(size=(5,)), jnp.bfloat16)},
        "opt_state": (jnp.asarray(r.integers(-128, 127, (7,)), jnp.int8),
                      {"count": jnp.asarray(3, jnp.int32)}),
        "step": jnp.asarray(11, jnp.int32),
        "flag": jnp.asarray([True, False]),
    }


@pytest.mark.parametrize("leaf", ["params.w", "params.h", "opt_state.0",
                                  "opt_state.count", "step", "flag"])
def test_roundtrip_is_bit_exact(tmp_path, leaf):
    mgr = CheckpointManager(tmp_path / "ck")
    s = _state()
    mgr.save(7, s)
    back = mgr.restore(7, _state(seed=1))
    get = {"params.w": lambda t: t["params"]["w"],
           "params.h": lambda t: t["params"]["h"],
           "opt_state.0": lambda t: t["opt_state"][0],
           "opt_state.count": lambda t: t["opt_state"][1]["count"],
           "step": lambda t: t["step"], "flag": lambda t: t["flag"]}[leaf]
    a, b = np.asarray(get(s)), np.asarray(get(back))
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_layout_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", max_to_keep=2)
    assert mgr.latest_step() is None and mgr.all_steps() == []
    for step in (2, 4, 6):
        mgr.save(step, _state(step))
    assert mgr.all_steps() == [4, 6] and mgr.latest_step() == 6
    d = tmp_path / "ck" / "6"
    assert sorted(p.name for p in d.iterdir()) == ["manifest.json",
                                                   "state.bin"]
    leaves = json.loads((d / "manifest.json").read_text())["leaves"]
    assert {e["dtype"] for e in leaves} >= {"float32", "bfloat16", "int8"}
    assert not list((tmp_path / "ck").glob(".tmp-*"))


def test_incomplete_step_is_ignored(tmp_path):
    """A save that died before its rename leaves only a .tmp- directory,
    which no restore can pick up."""
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(1, _state())
    (tmp_path / "ck" / ".tmp-2").mkdir()
    (tmp_path / "ck" / "3").mkdir()           # no manifest
    assert mgr.all_steps() == [1]


def test_restore_checks_structure(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(1, _state())
    bad = _state()
    bad["params"]["w"] = jnp.zeros((4, 4))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, bad)
    extra = dict(_state(), teacher={"w": jnp.zeros(2)})
    with pytest.raises(KeyError, match="teacher"):
        mgr.restore(1, extra)


def test_delete_all(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(1, _state())
    mgr.delete_all()
    assert mgr.latest_step() is None
    mgr.save(1, {"x": jax.numpy.ones(2)})
    assert mgr.all_steps() == [1]
