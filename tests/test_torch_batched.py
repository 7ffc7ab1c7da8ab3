"""The port's batched multi-object fit (`gp.batched`) against the JAX
package's, on the CPU in float64: ragged clouds padded to one capacity,
each object's posterior at shared queries held to JAX's vmapped fit at
BASELINE.md row 2's 1e-6 and to a single-object fit of the port at 1e-12,
and `fit_batch(mesh=)` on two gloo ranks (`tests/torch_session_rank.py`,
no jax), each rank its contiguous share of the objects."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu.gp import batched as jgpb
from gpis_tpu.kernels import functions as jkf
from gpis_tpu_torch.gp import batched as gpb
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.kernels import functions as kf
from torch_ranks import spawn_ranks

TOL = 1e-6
SIZES = (50, 80, 70, 20)


def _objects():
    rng = np.random.default_rng(21)
    clouds = [rng.normal(size=(n, 3)) for n in SIZES]
    ys = [rng.normal(size=n) * 0.3 for n in SIZES]
    return clouds, ys, rng.uniform(-1.5, 1.5, size=(64, 3))


@pytest.fixture(scope="module")
def fits():
    clouds, ys, q = _objects()
    noises = [1e-3, np.full(SIZES[1], 2e-3), 1e-3, 5e-4]
    model = gpb.fit_batch("rbf", clouds, ys, noises, kf.kernel_params(0.8, 1.0), block=32,
                          dtype=torch.float64)
    jmodel = jgpb.fit_batch("rbf", [jnp.asarray(c) for c in clouds], ys, noises,
                            jkf.kernel_params(0.8, 1.0), block=32, dtype=jnp.float64)
    return model, jmodel, clouds, ys, noises, q


def test_fit_batch_pads_ragged_clouds_as_jax(fits):
    model, jmodel, *_ = fits
    assert model.x.shape == (4, 96, 3) and model.chol.shape == (4, 96, 96)
    assert model.n0 == 96 and jmodel.n0 == 96
    for key in ("x", "y", "noise", "alpha", "chol"):
        np.testing.assert_allclose(getattr(model, key).numpy(), np.asarray(getattr(jmodel, key)),
                                   atol=TOL)


def test_predict_batch_matches_jax_and_single_fits(fits):
    model, jmodel, clouds, ys, noises, q = fits
    mean, var = gpb.predict_batch(model, q)
    jmean, jvar = jgpb.predict_batch(jmodel, jnp.asarray(q))
    assert mean.shape == var.shape == (4, 64)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=TOL)
    for b, (x, y, nz) in enumerate(zip(clouds, ys, noises)):
        xp, yp, np_ = gpr.pad_training(torch.as_tensor(x), torch.as_tensor(y),
                                        torch.as_tensor(nz), 96, 1e10)
        one = gpr.fit_padded("rbf", xp, yp, np_, kf.kernel_params(0.8, 1.0), n0=96)
        m1, v1 = gpr.predict(one, torch.as_tensor(q))
        np.testing.assert_allclose(mean[b].numpy(), m1.numpy(), atol=1e-12)
        np.testing.assert_allclose(var[b].numpy(), v1.numpy(), atol=1e-12)


def test_fit_batch_on_two_ranks_takes_each_rank_its_share(fits, tmp_path):
    model, *_ = fits
    clouds, ys, q = _objects()
    inputs = dict(n_objects=np.array(len(clouds)), q=q,
                  **{f"cloud{i}": c for i, c in enumerate(clouds)},
                  **{f"y{i}": y for i, y in enumerate(ys)})
    outs = spawn_ranks("torch_session_rank.py", ["batched"], 2, inputs, tmp_path)
    noises = [1e-3] * 4
    want = gpb.predict_batch(gpb.fit_batch("rbf", clouds, ys, noises, kf.kernel_params(0.8, 1.0),
                                           block=32, dtype=torch.float64), q)
    for r, out in enumerate(outs):
        assert out["imported"] == ""
        np.testing.assert_allclose(out["mean"], want[0][2 * r:2 * r + 2].numpy(), atol=1e-12)
        np.testing.assert_allclose(out["var"], want[1][2 * r:2 * r + 2].numpy(), atol=1e-12)
