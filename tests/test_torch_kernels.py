"""The port's kernel modules (gpis_tpu_torch) against the JAX package.

Each kernel's plain PyTorch twin -- what the wrapper runs on a CPU tensor --
is fed the same float64 arrays as its Pallas counterpart (interpret mode on
the CPU, as tests/test_pallas_gram.py and tests/test_linalg.py run them).
tests/test_torch_cuda.py holds the CUDA kernels themselves to these twins on
a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cov_cases
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.config import ModelConfig
from gpis_tpu.kernels import functions as jkf
from gpis_tpu.kernels import gram as jgram
from gpis_tpu.kernels import pallas_gram as jpg
from gpis_tpu.linalg import pallas_chol as jpc
from gpis_tpu.kernels import pallas_query as jpq
from gpis_tpu_torch import _build
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.data.gpis import fibonacci_sphere
from gpis_tpu_torch.kernels import cuda_gram, cuda_query
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.kernels import gram as kg
from gpis_tpu_torch.linalg import cholesky as lin
from gpis_tpu_torch.linalg import cuda_chol

KERNELS = ["rbf", "thin_plate", "laplace", "inverse_multiquadric"]
# Thin plate's scale R must exceed the cloud's diameter to stay usable.
LENGTHSCALE = {"rbf": 0.8, "thin_plate": 2.5, "laplace": 0.8, "inverse_multiquadric": 0.8}


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _spd(rng, n):
    g = rng.normal(size=(n, n))
    return g @ g.T / n + np.eye(n)


@pytest.mark.parametrize("name", KERNELS)
def test_k_r2_and_k_diag0_match_jax(name):
    rng = np.random.default_rng(1)
    r2 = np.concatenate([[0.0, 1e-40], rng.uniform(0, 9, size=200)])
    ls, sv = LENGTHSCALE[name], 1.3
    got = kf.k_r2(name, _t(r2), kf.kernel_params(ls, sv))
    want = jkf.k_r2(name, jnp.asarray(r2), jkf.kernel_params(ls, sv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    assert abs(kf.k_diag0(name, kf.kernel_params(ls, sv))
               - float(jkf.k_diag0(name, jkf.kernel_params(ls, sv)))) < 1e-12


@pytest.mark.parametrize("n", [100, 256, 700])
@pytest.mark.parametrize("name", ["rbf", "thin_plate"])
def test_gram_twin_matches_gram_pallas(n, name):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 3))
    noise = rng.uniform(1e-4, 1e-2, size=n)
    ls = LENGTHSCALE[name]
    got = kg.gram(name, _t(x), kf.kernel_params(ls, 1.1), noise=_t(noise))
    want = jpg.gram_pallas(name, jnp.asarray(x), jkf.kernel_params(ls, 1.1), jnp.asarray(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("noise", ["vector", "scalar", None])
@pytest.mark.parametrize("name", KERNELS)
def test_gram_reference_and_add_noise_diag_match_jax(name, noise):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(150, 3))
    nz = {"vector": rng.uniform(1e-4, 1e-2, size=150), "scalar": 3e-3, None: None}[noise]
    ls = LENGTHSCALE[name]
    tn = None if nz is None else _t(nz)
    got = kg.gram_reference(name, _t(x), kf.kernel_params(ls, 1.2), noise=tn)
    want = jgram.gram_reference(name, jnp.asarray(x), jkf.kernel_params(ls, 1.2), noise=nz)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    if nz is not None:
        base = kg.gram_reference(name, _t(x), kf.kernel_params(ls, 1.2))
        want = jgram.add_noise_diag(jnp.asarray(base.numpy()), nz)
        np.testing.assert_allclose(kg.add_noise_diag(base, tn).numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", KERNELS)
def test_cross_cov_twin_matches_cross_cov_pallas(name):
    rng = np.random.default_rng(7)
    q, x = rng.normal(size=(300, 3)), rng.normal(size=(700, 3))
    ls = LENGTHSCALE[name]
    got = kg.cross_cov(name, _t(q), _t(x), kf.kernel_params(ls, 0.9))
    want = jpg.cross_cov_pallas(name, jnp.asarray(q), jnp.asarray(x), jkf.kernel_params(ls, 0.9))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode, m, n", torch_cov_cases.edge_cases())
@pytest.mark.parametrize("name", KERNELS)
def test_cov_twin_matches_pallas_at_tile_edges(name, mode, m, n):
    """The twin Kernel A is held to on the card, against the JAX Pallas
    calls in interpret mode, float64 at 1e-12: cross_cov_pallas,
    gram_pallas (noise on the diagonal) and gram_band_pallas (m rows at
    row0, with noise)."""
    x, noise, q, row0 = torch_cov_cases.edge_inputs(mode, m, n)
    ls = LENGTHSCALE[name]
    tp, jp = kf.kernel_params(ls, 1.1), jkf.kernel_params(ls, 1.1)
    if mode == "cross":
        got = cuda_gram.cov(name, _t(q), _t(x), tp)
        want = jpg.cross_cov_pallas(name, jnp.asarray(q), jnp.asarray(x), jp)
    elif mode == "gram":
        got = cuda_gram.cov(name, _t(x), _t(x), tp, noise=_t(noise), sym=True)
        want = jpg.gram_pallas(name, jnp.asarray(x), jp, jnp.asarray(noise))
    else:
        band, nb = x[row0:row0 + m], noise[row0:row0 + m]
        got = cuda_gram.cov(name, _t(band), _t(x), tp, noise=_t(nb), sym=True, row0=row0)
        want = jpg.gram_band_pallas(name, jnp.asarray(band), jnp.asarray(x), jp,
                                    jnp.asarray(nb), row0)
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_panel_update_twin_matches_pallas():
    rng = np.random.default_rng(3)
    n, b, j0 = 1024, 256, 512
    l = np.tril(rng.normal(size=(n, n))) * (np.arange(n) < j0)[None, :]
    a_panel = rng.normal(size=(n, b))
    want = np.asarray(jpc.panel_update_pallas(jnp.asarray(l), jnp.asarray(l[j0:j0 + b]),
                                              jnp.asarray(a_panel), j0, block=b))
    m = l.copy()
    m[:, j0:j0 + b] = a_panel
    got = cuda_chol.panel_update(_t(m), j0, b).numpy()
    # The Pallas kernel skips whole row tiles above j0 (tile-granular, as
    # tests/test_linalg.py derives it); the port skips exactly the rows < j0.
    tn = jpc._PANEL_TILE
    while n % tn or b > tn:
        tn //= 2
    lo = max((j0 // tn) * tn, j0)
    np.testing.assert_allclose(got[lo:, j0:j0 + b], want[lo:], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got[:j0, j0:j0 + b], a_panel[:j0])
    np.testing.assert_array_equal(np.delete(got, np.s_[j0:j0 + b], axis=1),
                                  np.delete(m, np.s_[j0:j0 + b], axis=1))


@pytest.mark.parametrize("j0", [0, 256])
def test_row_update_twin_matches_pallas(j0):
    rng = np.random.default_rng(4)
    n, b = 512, 256
    w = np.tril(rng.normal(size=(n, n)))
    l_row = rng.normal(size=(b, n))
    want = jpc.row_update_pallas(jnp.asarray(w), jnp.asarray(l_row), j0, block=b)
    got = cuda_chol.row_update(_t(w), _t(l_row), j0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_blocked_cholesky_matches_pallas():
    a = _spd(np.random.default_rng(5), 512)
    want = np.asarray(jpc.pallas_blocked_cholesky(jnp.asarray(a), block=256))
    got = cuda_chol.blocked_cholesky(_t(a).clone(), 256).numpy()
    np.testing.assert_allclose(got, want, atol=1e-8)
    assert np.abs(np.triu(got, 1)).max() == 0.0


@pytest.mark.parametrize("inplace", [True, False])
def test_blocked_linv_matches_pallas(inplace):
    l = np.linalg.cholesky(_spd(np.random.default_rng(6), 512))
    want = np.asarray(jpc.pallas_blocked_linv(jnp.asarray(l), 256, inplace=inplace))
    got = cuda_chol.blocked_linv(_t(l).clone(), 256, inplace=inplace).numpy()
    np.testing.assert_allclose(got, want, atol=1e-8)
    np.testing.assert_allclose(got @ l, np.eye(512), atol=1e-8)
    assert np.abs(np.triu(got, 1)).max() == 0.0


def test_blocked_cholesky_flags_indefinite_with_nan():
    a = _t(_spd(np.random.default_rng(8), 512))
    a[300, 300] = -5.0
    assert torch.isnan(cuda_chol.blocked_cholesky(a, 256).diagonal()).all()
    b = _t(_spd(np.random.default_rng(8), 64))
    b[10, 10] = -5.0
    assert torch.isnan(lin.cholesky(b).diagonal()).all()


def _query_problem(name, c=1024, m=1024):
    """A fitted float64 GP of capacity c: (q, x, params, alpha, W)."""
    rng = np.random.default_rng(20260818 + c)
    x = rng.normal(size=(c, 3))
    if name == "thin_plate":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    ls, noise = (2.5, 1e-2) if name == "thin_plate" else (0.8, 1e-3)
    params = kf.kernel_params(ls, 1.0)
    k = kg.gram(name, _t(x), params, noise=noise)
    l = torch.linalg.cholesky(k)
    w = torch.linalg.solve_triangular(l, torch.eye(c, dtype=k.dtype), upper=False)
    alpha = torch.cholesky_solve(_t(rng.normal(size=(c, 1)) * 0.2), l)[:, 0]
    return _t(rng.normal(size=(m, 3))), _t(x), params, alpha, w


@pytest.mark.parametrize("name", ["rbf", "thin_plate"])
def test_staged_quad_twin_matches_staged_query_from_kq(name):
    q, x, params, alpha, w = _query_problem(name)
    kq = cuda_query.stage_kq(name, q, x, params)
    mean, quad = cuda_query.staged_quad(kq, w, alpha)
    ti, tc = jpq._TI, jpq._TC
    while 1024 % ti:
        ti //= 2
    jmean, jquad = jpq.staged_query_from_kq(jnp.asarray(kq.numpy()), jnp.asarray(w.numpy()),
                                            jnp.asarray(alpha.numpy())[None, :], ti=ti, tc=tc)
    # The Pallas kernel keeps v = W kq^T in a float32 scratch and its mean
    # dot accumulates with preferred_element_type=float32, so both outputs
    # are float32-grade even on float64 inputs: hold them to that.
    np.testing.assert_allclose(quad.numpy(), np.asarray(jquad)[0], rtol=1e-5, atol=1e-5)
    scale = (kq.abs() @ alpha.abs()).numpy()
    assert np.all(np.abs(mean.numpy() - np.asarray(jmean)[0]) <= 1e-6 * scale + 1e-12)


def test_fused_query_matches_fused_query_pallas_staged():
    q, x, params, alpha, w = _query_problem("rbf", m=100)
    mean, quad = cuda_query.fused_query("rbf", q, x, params, alpha, w)
    jmean, jquad = jpq.fused_query_pallas("rbf", jnp.asarray(q.numpy()), jnp.asarray(x.numpy()),
                                          jkf.kernel_params(0.8, 1.0), jnp.asarray(alpha.numpy()),
                                          jnp.asarray(w.numpy()), staged=True)
    # float32-grade on the Pallas side (see the test above).
    np.testing.assert_allclose(quad.numpy(), np.asarray(jquad), rtol=1e-5, atol=1e-5)
    scale = (kg.cross_cov("rbf", q, x, params).abs() @ alpha.abs()).numpy()
    assert np.all(np.abs(mean.numpy() - np.asarray(jmean)) <= 1e-6 * scale + 1e-12)


@pytest.mark.parametrize("name", ["rbf", "thin_plate"])
def test_fused_quad_twin_matches_fused_query_pallas_on_the_fly(name):
    q, x, params, alpha, w = _query_problem(name, m=300)
    mean, quad = cuda_query.fused_query(name, q, x, params, alpha, w, staged=False)
    jmean, jquad = jpq.fused_query_pallas(name, jnp.asarray(q.numpy()), jnp.asarray(x.numpy()),
                                          jkf.kernel_params(params["lengthscale"], 1.0),
                                          jnp.asarray(alpha.numpy()), jnp.asarray(w.numpy()),
                                          staged=False)
    # float32-grade on the Pallas side, as in the staged test above.
    np.testing.assert_allclose(quad.numpy(), np.asarray(jquad), rtol=1e-5, atol=1e-5)
    scale = (kg.cross_cov(name, q, x, params).abs() @ alpha.abs()).numpy()
    assert np.all(np.abs(mean.numpy() - np.asarray(jmean)) <= 1e-6 * scale + 1e-12)


def _spy_routes(monkeypatch, module):
    """Record which of staged_quad (staged route) and fused_quad (Kernel F)
    `module` reaches."""
    calls = []
    for fn in ("staged_quad", "fused_quad"):
        real = getattr(module, fn)
        monkeypatch.setattr(module, fn,
                            lambda *a, _real=real, _fn=fn: calls.append(_fn) or _real(*a))
    return calls


@pytest.mark.parametrize("over_cap,staged,route", [
    (False, None, "staged_quad"), (True, None, "fused_quad"),
    (True, True, "staged_quad"), (False, False, "fused_quad")])
def test_fused_query_routes_by_staged_size(monkeypatch, over_cap, staged, route):
    q, x, params, alpha, w = _query_problem("rbf", c=128, m=64)
    if over_cap:
        monkeypatch.setattr(cuda_query, "KQ_STAGE_MAX", 64 * 128 * 8 - 1)
    calls = _spy_routes(monkeypatch, cuda_query)
    mean, quad = cuda_query.fused_query("rbf", q, x, params, alpha, w, staged=staged)
    assert calls == [route]
    want = cuda_query.staged_quad_reference(kg.cross_cov("rbf", q, x, params), w, alpha)
    np.testing.assert_allclose(mean.numpy(), want[0].numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(quad.numpy(), want[1].numpy(), rtol=1e-12, atol=1e-12)


def test_query_over_the_stage_cap_matches_jax(monkeypatch):
    # A query whose staged kq would exceed KQ_STAGE_MAX: the JAX package
    # answers it (its on-the-fly kernel), and so must the port.
    cfg = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=64,
                      touch_capacity=0, dtype="float64")
    pts = fibonacci_sphere(400) * 1.3 + np.array([0.2, -0.4, 0.1])
    qpts = np.random.default_rng(21).uniform(-1.5, 1.5, size=(300, 3))
    sess = ObjectModelSession(cfg, device="cpu").start(pts)
    monkeypatch.setattr(cuda_query, "KQ_STAGE_MAX", 4096)
    np.testing.assert_allclose(sess.query(qpts), JaxSession(cfg).start(pts).query(qpts),
                               atol=1e-6)
    q, x, params, alpha, w = _query_problem("rbf", c=256, m=64)
    mean, quad = cuda_query.fused_query("rbf", q, x, params, alpha, w)
    kq = jgram.cross_cov("rbf", jnp.asarray(q.numpy()), jnp.asarray(x.numpy()),
                         jkf.kernel_params(0.8, 1.0))
    v = jnp.asarray(w.numpy()) @ kq.T
    np.testing.assert_allclose(mean.numpy(), np.asarray(kq @ jnp.asarray(alpha.numpy())),
                               atol=1e-6)
    np.testing.assert_allclose(quad.numpy(), np.asarray(jnp.sum(v * v, axis=0)), atol=1e-6)


def test_wrappers_validate_before_launch():
    x = torch.zeros((10, 3))
    with pytest.raises(ValueError):
        cuda_gram.cov("rbf", x, torch.zeros((10, 2)), kf.kernel_params())
    with pytest.raises(ValueError):
        cuda_gram.cov("rbf", x, torch.zeros((11, 3)), kf.kernel_params(), sym=True)
    with pytest.raises(ValueError):
        cuda_chol.panel_update(torch.zeros((8, 8)), 4, 8)
    with pytest.raises(ValueError):
        cuda_query.staged_quad(torch.zeros((4, 8)), torch.zeros((8, 8)), torch.zeros(7))
    with pytest.raises(ValueError):
        cuda_query.fused_quad("value", "rbf", torch.zeros((4, 3)), torch.zeros((8, 7)),
                              kf.kernel_params(), torch.zeros(8), torch.zeros((8, 8)))
    with pytest.raises(ValueError):
        cuda_query.fused_quad("other", "rbf", torch.zeros((4, 3)), torch.zeros((8, 3)),
                              kf.kernel_params(), torch.zeros(8), torch.zeros((8, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_cuda_args("test", x)
    with pytest.raises(TypeError):
        _build.check_cuda_args("test", x.to(torch.float16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_takes_kernel_refuses_float64_off_the_cpu(dtype):
    """The tensor-core kernels' routing rule: a CPU tensor takes the twin in
    either dtype; off the CPU (a meta tensor stands for a card's here)
    float32 takes the kernel and float64 raises, in the wrappers too."""
    assert not _build.takes_kernel("test", torch.zeros(2, dtype=dtype))
    meta = torch.empty((8, 8), dtype=dtype, device="meta")
    if dtype == torch.float32:
        assert _build.takes_kernel("test", meta)
        return
    with pytest.raises(TypeError, match="float64"):
        _build.takes_kernel("test", meta)
    with pytest.raises(TypeError, match="panel_update"):
        cuda_chol.panel_update(meta, 0, 8)


def test_twins_launch_nothing_on_cpu():
    _build.LAUNCHES.clear()
    q, x, params, alpha, w = _query_problem("rbf", c=256, m=64)
    for staged in (True, False):
        cuda_query.fused_query("rbf", q, x, params, alpha, w, staged=staged)
    m = w.clone()
    cuda_chol.blocked_linv(m, 128, inplace=True)
    assert sum(_build.LAUNCHES.values()) == 0

