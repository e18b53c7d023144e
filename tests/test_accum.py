"""f64-accumulated inner products of f32 vectors (IterativeSolver::Dot,
linalg/solvers.cpp:58): the mixed-precision CG dots, serial
(``linalg.solvers.default_dot``) and sharded (``parallel.ops.make_pdot``).
Plain f32 tree sums stagnate at ~4e-7 relative error under cancellation,
so both must accumulate far below that."""

import jax
import jax.numpy as jnp
import numpy as np


def _cancelling_pair(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    ref = np.dot(x.astype(np.float64), y.astype(np.float64))
    scale = np.dot(np.abs(x).astype(np.float64), np.abs(y).astype(np.float64))
    return x, y, ref, scale


def test_default_dot_unchanged_on_cpu():
    # the native-f64 path: bitwise the f64 vdot rounded to the input dtype
    from cardiac_ablation_ecm2.linalg.solvers import default_dot

    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal(1000).astype(np.float32))
    y = jnp.asarray(rng.standard_normal(1000).astype(np.float32))
    expect = jnp.vdot(
        x.astype(jnp.float64), y.astype(jnp.float64)
    ).astype(x.dtype)
    assert float(default_dot(x, y)) == float(expect)


def test_default_dot_accumulates_f32_in_f64():
    from cardiac_ablation_ecm2.linalg.solvers import default_dot

    x, y, ref, scale = _cancelling_pair(300_001, 4)
    got = jax.jit(default_dot)(jnp.asarray(x), jnp.asarray(y))
    assert got.dtype == jnp.float32
    # only the final f32 rounding of the exact f64 sum remains
    assert abs(float(got) - ref) <= abs(ref) * 2 ** -23 + scale * 1e-12


def test_make_pdot_accumulates_f32_in_f64_on_4_devices():
    from jax.sharding import Mesh, PartitionSpec as P

    from cardiac_ablation_ecm2.parallel.ops import AXIS, make_pdot

    devs = jax.devices()[:4]
    assert len(devs) == 4
    n = 4 * 75_000
    x, y, ref, scale = _cancelling_pair(n, 6)
    w = np.ones(n, np.float32)
    w[::7] = 0.5                     # shared-dof multiplicity weights
    # pdot forms the weighted products in f32; only the sum must be f64
    ref = np.sum((x * w * y).astype(np.float64))

    def local(a, b, wt):
        return make_pdot(wt[0])(a[0], b[0])[None]

    f = jax.jit(jax.shard_map(
        local, mesh=Mesh(np.array(devs), (AXIS,)),
        in_specs=(P(AXIS), P(AXIS), P(AXIS)), out_specs=P(AXIS)))
    out = np.asarray(f(*(jnp.asarray(v.reshape(4, -1)) for v in (x, y, w))))
    assert out.dtype == np.float32
    assert np.all(out == out[0])     # psum: every device holds the total
    assert abs(float(out[0]) - ref) <= abs(ref) * 2 ** -23 + scale * 1e-12
