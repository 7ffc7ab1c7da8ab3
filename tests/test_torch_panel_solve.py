"""The port's `panel_solve="inv"` option of the in-core factor and TRSM
(Kernels J and K) against the JAX package's, on the CPU in float64.

The twins of J and K are held to `panel_scale_pallas` and
`row_scale_pallas` in interpret mode, at shapes that take their Pallas
branch (rows or columns % 256 == 0, B % 128 == 0), where `_dot3` is an
exact dot: the bar is 1e-10.  The blocked factor and TRSM are held to
`pallas_blocked_cholesky` / `pallas_blocked_linv(panel_solve="inv")` at
1e-6 (BASELINE.md row 2), and a session in a process started with
GPIS_PANEL_SOLVE=inv to the default route's.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu.linalg.pallas_chol import (pallas_blocked_cholesky, pallas_blocked_linv,
                                         panel_scale_pallas, row_scale_pallas)
from gpis_tpu_torch import ModelConfig
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.data.gpis import fibonacci_sphere
from gpis_tpu_torch.linalg import cuda_chol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spd(rng, n):
    g = rng.normal(size=(n, n))
    return g @ g.T / n + np.eye(n)


def _lower_inv(rng, b):
    """A B x B V = Ljj^{-1}: lower-triangular, well conditioned."""
    ld = np.linalg.cholesky(_spd(rng, b))
    return np.linalg.solve(ld, np.eye(b)) * np.tri(b)


@pytest.mark.parametrize("r, b", [(512, 128), (768, 256)])
def test_panel_scale_twin_matches_pallas(r, b):
    rng = np.random.default_rng(1)
    acc, v = rng.normal(size=(r, b)), _lower_inv(rng, b)
    want = panel_scale_pallas(jnp.asarray(acc), jnp.asarray(v))
    got = cuda_chol.panel_scale(torch.as_tensor(acc), torch.as_tensor(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)


def test_panel_scale_takes_a_strided_panel():
    rng = np.random.default_rng(2)
    a, v = torch.as_tensor(rng.normal(size=(512, 512))), torch.as_tensor(_lower_inv(rng, 128))
    got = cuda_chol.panel_scale(a[128:, 256:384], v)
    want = panel_scale_pallas(jnp.asarray(a[128:, 256:384].numpy()), jnp.asarray(v.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)


@pytest.mark.parametrize("b, n", [(128, 512), (256, 768)])
def test_row_scale_twin_matches_pallas(b, n):
    rng = np.random.default_rng(3)
    v, rhs = _lower_inv(rng, b), rng.normal(size=(b, n))
    want = row_scale_pallas(jnp.asarray(v), jnp.asarray(rhs))
    got = cuda_chol.row_scale(torch.as_tensor(v), torch.as_tensor(rhs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)


@pytest.mark.parametrize("n, block", [(512, 128), (768, 256)])
def test_blocked_cholesky_inv_matches_pallas(n, block):
    a = _spd(np.random.default_rng(4), n)
    want = np.asarray(pallas_blocked_cholesky(jnp.asarray(a), block, panel_solve="inv"))
    # A copy: the port factors in place, and jax on the CPU may read a's memory.
    got = cuda_chol.blocked_cholesky(torch.tensor(a), block, panel_solve="inv")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("n, block", [(512, 128), (768, 256)])
def test_blocked_linv_inv_matches_pallas(n, block, inplace):
    l = np.linalg.cholesky(_spd(np.random.default_rng(5), n))
    want = np.asarray(pallas_blocked_linv(jnp.asarray(l), block, inplace=inplace,
                                          panel_solve="inv"))
    got = cuda_chol.blocked_linv(torch.tensor(l), block, inplace=inplace, panel_solve="inv")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_blocked_inv_route_matches_pallas_factor_then_inverse():
    """The whole inv route, factor then in-place TRSM, at four 256 blocks
    (J's panels R = 768 ... 256, K's rows N = 256 ... 1,024), each step held
    to the JAX package's at 1e-6."""
    a = _spd(np.random.default_rng(8), 1024)
    l_jax = pallas_blocked_cholesky(jnp.asarray(a), 256, panel_solve="inv")
    w_jax = np.asarray(pallas_blocked_linv(l_jax, 256, inplace=True, panel_solve="inv"))
    l = cuda_chol.blocked_cholesky(torch.tensor(a), 256, panel_solve="inv")
    np.testing.assert_allclose(l.numpy(), np.asarray(l_jax), atol=1e-6)
    w = cuda_chol.blocked_linv(l, 256, inplace=True, panel_solve="inv")
    np.testing.assert_allclose(w.numpy(), w_jax, atol=1e-6)


def test_inv_and_substitution_factor_alike():
    a = torch.as_tensor(_spd(np.random.default_rng(6), 512))
    l_inv = cuda_chol.blocked_cholesky(a.clone(), 128, panel_solve="inv")
    l_sub = cuda_chol.blocked_cholesky(a.clone(), 128, panel_solve="xla")
    np.testing.assert_allclose(l_inv.numpy(), l_sub.numpy(), atol=1e-10)
    w_inv = cuda_chol.blocked_linv(l_sub, 128, panel_solve="inv")
    w_sub = cuda_chol.blocked_linv(l_sub, 128, panel_solve="xla")
    np.testing.assert_allclose(w_inv.numpy(), w_sub.numpy(), atol=1e-10)


def test_unknown_panel_solve_raises():
    a = torch.as_tensor(_spd(np.random.default_rng(7), 256))
    with pytest.raises(ValueError, match="panel_solve"):
        cuda_chol.blocked_cholesky(a, 128, panel_solve="cusolver")


_SESSION = (
    "import sys, numpy as np\n"
    "from gpis_tpu_torch import ModelConfig\n"
    "from gpis_tpu_torch.api.session import ObjectModelSession\n"
    "from gpis_tpu_torch.data.gpis import fibonacci_sphere\n"
    "from gpis_tpu_torch.linalg import cuda_chol\n"
    "calls = {'panel_scale': 0, 'row_scale': 0}\n"
    "def spy(name, fn):\n"
    "    def call(*a):\n"
    "        calls[name] += 1\n"
    "        return fn(*a)\n"
    "    return call\n"
    "cuda_chol.panel_scale_reference = spy('panel_scale', cuda_chol.panel_scale_reference)\n"
    "cuda_chol.row_scale_reference = spy('row_scale', cuda_chol.row_scale_reference)\n"
    "cfg = ModelConfig(lengthscale=0.4, noise_surface=1e-3, touch_capacity=0, dtype='float64')\n"
    "pts = fibonacci_sphere(700)\n"
    "grids = [ObjectModelSession(cfg, device='cpu').start(pts, **kw).evaluate_grid(12, 1.5)\n"
    "         for kw in ({}, {'out_of_core': True})]\n"
    "np.savez(sys.argv[1], *[g for mean, var, _ in grids for g in (mean, var)])\n"
    "print(cuda_chol.PANEL_SOLVE, calls['panel_scale'], calls['row_scale'])\n"
)


def test_session_with_inv_env_matches_default(tmp_path):
    """GPIS_PANEL_SOLVE=inv, read at import, reaches the value session (K in
    fit_inference's TRSM) and the out-of-core one (J and K in its diagonal
    factor), whose grids match the default route's."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "GPIS_PANEL_SOLVE")}
    env["PYTHONPATH"] = REPO
    env["GPIS_PANEL_SOLVE"] = "inv"
    out = tmp_path / "grids.npz"
    proc = subprocess.run([sys.executable, "-c", _SESSION, str(out)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    mode, n_panel, n_row = proc.stdout.split()
    assert mode == "inv" and int(n_panel) > 0 and int(n_row) > 0, proc.stdout
    got = np.load(out)
    cfg = ModelConfig(lengthscale=0.4, noise_surface=1e-3, touch_capacity=0, dtype="float64")
    pts = fibonacci_sphere(700)
    want = []
    for kw in ({}, {"out_of_core": True}):
        sess = ObjectModelSession(cfg, device="cpu").start(pts, **kw)
        mean, var, _ = sess.evaluate_grid(12, 1.5)
        want += [mean, var]
    for i, w in enumerate(want):
        np.testing.assert_allclose(got[f"arr_{i}"], w, atol=1e-6)
