"""Sharded Orbax checkpointing (io/orbax_ckpt.py): save/restore sharded
arrays on the 8-device virtual mesh, including restore onto a DIFFERENT
sharding (restart on another mesh layout)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cardiac_ablation_ecm2.io.orbax_ckpt import ShardedCheckpointer


@pytest.fixture
def mesh8():
    devs = np.array(jax.devices()[:8])
    return Mesh(devs, ("x",))


def test_sharded_roundtrip(tmp_path, mesh8):
    sh = NamedSharding(mesh8, P("x"))
    T = jax.device_put(jnp.arange(4096, dtype=jnp.float32), sh)
    state = {"T": T, "t": 1.25, "cycle": 7}
    with ShardedCheckpointer(str(tmp_path / "ck")) as ck:
        ck.save(3, state, wait=True)
        assert ck.latest() == 3
        out = ck.restore(template={"T": T, "t": 0.0, "cycle": 0})
    assert np.allclose(np.asarray(out["T"]), np.arange(4096))
    assert out["t"] == 1.25 and out["cycle"] == 7
    assert out["T"].sharding.spec == P("x")


def test_restore_onto_different_sharding(tmp_path, mesh8):
    sh_save = NamedSharding(mesh8, P("x"))
    T = jax.device_put(jnp.arange(4096, dtype=jnp.float32), sh_save)
    with ShardedCheckpointer(str(tmp_path / "ck")) as ck:
        ck.save(0, {"T": T}, wait=True)
        # restart on a 2-device slice of the mesh
        mesh2 = Mesh(np.array(jax.devices()[:2]), ("x",))
        sh2 = NamedSharding(mesh2, P("x"))
        tmpl = {"T": jax.ShapeDtypeStruct((4096,), jnp.float32,
                                          sharding=sh2)}
        out = ck.restore(template=tmpl)
    assert np.allclose(np.asarray(out["T"]), np.arange(4096))
    assert len(out["T"].sharding.device_set) == 2


def test_max_to_keep_and_latest(tmp_path, mesh8):
    sh = NamedSharding(mesh8, P("x"))
    with ShardedCheckpointer(str(tmp_path / "ck"), max_to_keep=2) as ck:
        for s in range(4):
            T = jax.device_put(
                jnp.full(64, float(s), dtype=jnp.float32), sh)
            ck.save(s, {"T": T}, wait=True)
        assert ck.latest() == 3
        assert ck.all_steps() == [2, 3]
        out = ck.restore()       # latest, no template
    assert np.allclose(np.asarray(out["T"]), 3.0)
