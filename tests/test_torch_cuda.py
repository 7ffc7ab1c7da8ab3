"""The port's CUDA kernels against their plain PyTorch twins, on a card.

Every test here is marked `cuda` and skips without a card.  The file
imports nothing of jax or of the JAX package, so it runs on a machine
without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_cov_cases

from gpis_tpu_torch.config import ModelConfig
from gpis_tpu_torch import _build
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.data.gpis import fibonacci_sphere
from gpis_tpu_torch.gp import regression
from gpis_tpu_torch.kernels import cuda_gram, cuda_joint, cuda_query
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.kernels import gram as kg
from gpis_tpu_torch.linalg import cuda_chol
from gpis_tpu_torch.linalg import outofcore as ooc

pytestmark = pytest.mark.cuda

KERNELS = ["rbf", "thin_plate", "laplace", "inverse_multiquadric"]
LENGTHSCALE = {"rbf": 0.8, "thin_plate": 2.5, "laplace": 0.8, "inverse_multiquadric": 0.8}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (their twins run here)")
    return torch.device("cuda")


def _spd(rng, n):
    g = rng.normal(size=(n, n))
    return g @ g.T / n + np.eye(n)


# The card runs float32: a float32 run there against the same inputs'
# float64 run on the CPU (the twins), the largest mean and variance gaps.
# Where float32's own error on a problem is larger (random targets over a
# small noise), the gap may reach F32_OWN times the CPU's float32 twins'
# gap to float64 (split-TF32 products against the library's FP32 ones
# round in another order).
F32_MEAN_GAP, F32_VAR_GAP = 1e-4, 1e-3
F32_OWN = 4.0


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _assert_f32_close(got, want, own=None):
    """got (mean, var, ...), a float32 run on the card, against want, the
    float64 run on the CPU; own, if given, the CPU's float32 run."""
    gaps = [_gap(a, b) for a, b in zip(got[:2], want[:2])]
    tols = [F32_MEAN_GAP, F32_VAR_GAP]
    if own is not None:
        tols = [max(t, F32_OWN * _gap(a, b)) for t, a, b in zip(tols, own[:2], want[:2])]
    assert gaps[0] <= tols[0] and gaps[1] <= tols[1], (gaps, tols)


def _f32_f64(cfg):
    """cfg in float32 for the card and in float64 for the CPU."""
    return {"cuda": dataclasses.replace(cfg, dtype="float32"),
            "cpu": dataclasses.replace(cfg, dtype="float64")}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode, m, n", [("gram", 700, 700)] + torch_cov_cases.edge_cases())
@pytest.mark.parametrize("name", KERNELS)
def test_cuda_cov_matches_twin(cuda, name, mode, m, n, dtype):
    x, noise, q, row0 = (torch.as_tensor(v, dtype=dtype, device=cuda)
                         if isinstance(v, np.ndarray) else v
                         for v in torch_cov_cases.edge_inputs(mode, m, n))
    params = kf.kernel_params(LENGTHSCALE[name], 1.1)
    a, nz, sym = x, noise, True
    if mode == "cross":
        a, nz, sym = q, None, False
    elif mode == "band":
        a, nz = x[row0:row0 + m], noise[row0:row0 + m]
    torch.full((m, n), float("nan"), dtype=dtype, device=cuda)  # the next (m, n) block: NaN
    _build.LAUNCHES.clear()
    got = cuda_gram.cov(name, a, x, params, noise=nz, sym=sym, row0=row0)
    assert _build.LAUNCHES["gram_band" if mode == "band" else "cov"] == 1
    want = cuda_gram.cov_reference(name, a, x, params, noise=nz, sym=sym, row0=row0 or 0)
    # Only the rounding of r2 and k differs.
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    if sym:  # the pinned diagonal, k(0) + noise[i], bit for bit
        r0 = row0 or 0
        assert torch.equal(got[:, r0:r0 + m].diagonal(), want[:, r0:r0 + m].diagonal())


def test_cuda_panel_and_row_update_match_twins(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    n, b, j0 = 1024, 256, 512
    m = torch.randn((n, n), generator=gen, device=cuda) / j0**0.5
    got = cuda_chol.panel_update(m.clone(), j0, b)
    # f32 sums of j0 O(1/j0) products in two orders.
    torch.testing.assert_close(got, cuda_chol.panel_update_reference(m.clone(), j0, b),
                               rtol=1e-4, atol=1e-4)
    w = torch.tril(m)
    l_row = torch.randn((b, n), generator=gen, device=cuda) / j0**0.5
    torch.testing.assert_close(cuda_chol.row_update(w, l_row, j0),
                               cuda_chol.row_update_reference(w, l_row, j0), rtol=1e-4, atol=1e-4)


def test_cuda_blocked_factor_and_inverse(cuda):
    # float32 (Kernels B and C), held in float64 as the float32 tests below.
    a = torch.as_tensor(_spd(np.random.default_rng(12), 512), device=cuda)
    _build.LAUNCHES.clear()
    l = cuda_chol.blocked_cholesky(a.float(), 256)
    w = cuda_chol.blocked_linv(l.clone(), 256, inplace=True)
    assert _build.LAUNCHES["panel_update"] > 0 and _build.LAUNCHES["row_update"] > 0
    eye = torch.eye(512, dtype=torch.float64, device=cuda)
    assert (l.double() @ l.double().T - a).abs().max().item() < 1e-5
    assert (w.double() @ l.double() - eye).abs().max().item() < 1e-5


QUAD_REL_TOL = 1e-4  # chip_smoke.py's: the quad per query against the float64 twin


def _assert_quad_close(mean, quad, mean_r, quad_r, kq, alpha):
    """float32 (the tensor-core tile) against the twin run in float64 on the
    same values: each query's quad within 1e-4 of itself, the mean within
    1e-4 x sum|kq||alpha|."""
    ref = quad_r.clamp_min(torch.finfo(torch.float64).tiny)
    rel = ((quad.double() - quad_r).abs() / ref).max().item()
    assert rel <= QUAD_REL_TOL, rel
    if mean is not None:
        err = (mean.double() - mean_r).abs().max().item()
        assert err <= 1e-4 * (kq.abs() @ alpha.abs()).max().item(), err


def test_cuda_staged_quad_matches_twin(cuda):
    rng = np.random.default_rng(13)
    c, m = 1024, 1000
    x = torch.as_tensor(rng.normal(size=(c, 3)), device=cuda)
    q = torch.as_tensor(rng.normal(size=(m, 3)), device=cuda)
    params = kf.kernel_params(0.8, 1.0)
    l = torch.linalg.cholesky(kg.gram("rbf", x, params, noise=1e-3))
    # solve_triangular returns column-major; the kernels take row-major only.
    w = torch.linalg.solve_triangular(l, torch.eye(c, dtype=l.dtype, device=cuda),
                                      upper=False).float().contiguous()
    alpha = torch.as_tensor(rng.normal(size=c), dtype=torch.float32, device=cuda)
    kq = cuda_query.stage_kq("rbf", q.float(), x.float(), params)
    _build.LAUNCHES.clear()
    mean, quad = cuda_query.staged_quad(kq, w, alpha)
    assert _build.LAUNCHES["staged_quad"] == 1
    mean_r, quad_r = cuda_query.staged_quad_reference(kq.double(), w.double(), alpha.double())
    _assert_quad_close(mean, quad, mean_r, quad_r, kq.double(), alpha.double())


def test_cuda_untiled_fit_padded_then_linv_matches_cpu(cuda):
    # n >= 4096 that the 256 block does not tile: the identity-padded blocked
    # factor, then W = L^{-1} and the staged query, float32 on the card
    # against the CPU path in float64.
    rng = np.random.default_rng(14)
    n = 4200
    x, y, q = rng.normal(size=(n, 3)), rng.normal(size=n) * 0.2, rng.normal(size=(500, 3))
    params = kf.kernel_params(0.8, 1.0)
    out = []
    for dev, dt in ((cuda, torch.float32), ("cpu", torch.float64), ("cpu", torch.float32)):
        _build.LAUNCHES.clear()
        t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
        model = regression.with_linv(
            regression.fit_padded("rbf", t(x), t(y), t(np.full(n, 1e-2)), params, n0=n))
        assert model.chol.is_contiguous() and not torch.isnan(model.chol.diagonal()).any()
        out.append([v.cpu().numpy() for v in regression.predict(model, t(q))])
        if dev is cuda:
            for name in ("cov", "panel_update", "staged_quad"):
                assert _build.LAUNCHES[name] > 0, name
    _assert_f32_close(*out)


@pytest.mark.parametrize("layout", ["aligned", "ragged", "band"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["rbf", "thin_plate", "inverse_multiquadric"])
def test_cuda_joint_rows_matches_twin(cuda, name, dtype, layout):
    # aligned: J = 4 x 300 + 64 (rows on 16 bytes: Kernel E's vector
    # stores); ragged: T = 63, J = 1,263 (J % 4 = 3: its scalar path, the
    # kinds' boundaries mid-tile); band: 300 rows at row0 700 with noise.
    rng = np.random.default_rng(15)
    x = rng.normal(size=(300, 3))
    x[100:120] = x[:20]  # coincident points: the pinned k and masked d2k
    tx = rng.normal(size=(63 if layout == "ragged" else 64, 3))
    params = kf.kernel_params(3.0 if name == "thin_plate" else 0.8, 1.1)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)  # noqa: E731
    meta = cuda_joint.joint_meta(t(x), t(tx))
    noise = t(rng.uniform(1e-3, 1e-2, size=meta[0].shape[0]))
    qmeta = cuda_joint.value_meta(t(np.concatenate([x[:30], rng.normal(size=(500, 3))])))
    # float64: only rounding order differs.  float32: values are O(10) at
    # most, and the two sides round exp and r2 differently.
    tol = 1e-10 if dtype == torch.float64 else 2e-5
    cases = [(meta, noise, 0), (qmeta, None, 0)]
    if layout == "band":
        cases = [(tuple(m[700:1000] for m in meta), noise, 700)]
    for rows, noise_col, row0 in cases:
        got = cuda_joint.joint_rows(name, rows, meta, params, noise_col=noise_col, row0=row0)
        want = cuda_joint.joint_rows_reference(name, rows, meta, params, noise_col=noise_col,
                                               row0=row0)
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("gen", ["value", "joint"])
def test_cuda_fused_quad_matches_twin(cuda, gen):
    dtype = torch.float32
    rng = np.random.default_rng(16)
    c, m = 256, 1000
    x = torch.as_tensor(rng.normal(size=(c, 3)), dtype=dtype, device=cuda)
    params = kf.kernel_params(0.8, 1.0)
    cols = x if gen == "value" else cuda_joint.pack_meta(cuda_joint.joint_meta(x))
    n = cols.shape[0]
    w = torch.tril(torch.as_tensor(rng.normal(size=(n, n)), dtype=dtype, device=cuda))
    alpha = torch.as_tensor(rng.normal(size=n), dtype=dtype, device=cuda)
    q = torch.as_tensor(rng.normal(size=(m, 3)), dtype=dtype, device=cuda)
    _build.LAUNCHES.clear()
    mean, quad = cuda_query.fused_quad(gen, "rbf", q, cols, params, alpha, w)
    assert _build.LAUNCHES["fused_quad"] == 1
    kq = cuda_query.generated_kq(gen, "rbf", q.double(), cols.double(), params)
    mean_r, quad_r = cuda_query.staged_quad_reference(kq, w.double(), alpha.double())
    _assert_quad_close(mean, quad, mean_r, quad_r, kq, alpha.double())


def test_cuda_joint_session_matches_cpu_session(cuda, monkeypatch):
    cfgs = _f32_f64(ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3,
                                n_external=127, touch_capacity=128))
    pts = fibonacci_sphere(384) * 1.3 + np.array([0.2, 0.0, -0.5])
    nrm = (pts - np.array([0.2, 0.0, -0.5])) / 1.3
    _build.LAUNCHES.clear()
    sessions = [ObjectModelSession(c, device=d).start(pts, normals=nrm) for d, c in cfgs.items()]
    got, want = (s.evaluate_grid(16, 1.5) for s in sessions)
    for name in ("joint_cov", "staged_quad"):  # J = 2,176: the library's factor
        assert _build.LAUNCHES[name] > 0, name
    _assert_f32_close(got, want)
    # Over the staging cap: the on-the-fly joint route (Kernel F).
    monkeypatch.setattr(cuda_query, "KQ_STAGE_MAX", 4096)
    _build.LAUNCHES.clear()
    got, want = (s.query(pts[:100]) for s in sessions)
    assert _build.LAUNCHES["fused_quad"] == 1
    _assert_f32_close(got, want)


def test_cuda_session_matches_cpu_session(cuda):
    cfgs = _f32_f64(ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3,
                                n_external=127, touch_capacity=0))
    pts = fibonacci_sphere(896) * 1.3 + np.array([0.2, 0.0, -0.5])
    _build.LAUNCHES.clear()
    got, want = (ObjectModelSession(c, device=d).start(pts).evaluate_grid(16, 1.5)
                 for d, c in cfgs.items())
    for name in ("cov", "row_update", "staged_quad"):  # C = 1,024: the library's factor
        assert _build.LAUNCHES[name] > 0, name
    _assert_f32_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_gram_band_matches_twin(cuda, dtype):
    rng = np.random.default_rng(17)
    x = torch.as_tensor(rng.normal(size=(900, 3)), dtype=dtype, device=cuda)
    noise = torch.as_tensor(rng.uniform(1e-3, 1e-2, size=300), dtype=dtype, device=cuda)
    params = kf.kernel_params(0.8, 1.1)
    _build.LAUNCHES.clear()
    got = cuda_gram.cov("rbf", x[450:750], x, params, noise=noise, sym=True, row0=450)
    assert _build.LAUNCHES["gram_band"] == 1 and _build.LAUNCHES["cov"] == 0
    want = cuda_gram.cov_reference("rbf", x[450:750], x, params, noise=noise, sym=True, row0=450)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# Kernel I's cases: (dtype, c0, blk's width W, blk's leading dimension, blk's
# first column in it).  16-byte vectors where dst + c0 and blk sit at one
# offset mod 16 bytes with both pitches multiples of 16 bytes, a scalar head
# and tail around them; scalars alone where they do not (an odd pitch, other
# offsets).  Every case exact.
_STRIPE_CASES = [
    (torch.float32, 0, 300, 500, 100), (torch.float32, 100, 300, 500, 100),
    (torch.float32, 700, 300, 500, 100),                        # aligned: vectors only
    (torch.float32, 0, 301, 304, 0),                            # vectors, a tail of 1
    (torch.float32, 3, 7, 16, 3), (torch.float32, 1, 301, 304, 1),  # one offset: head, tail
    (torch.float32, 1, 7, 16, 0), (torch.float32, 3, 301, 304, 0),  # two offsets: scalars
    (torch.float32, 0, 301, 301, 0), (torch.float32, 4, 7, 7, 0),   # an odd pitch: scalars
    (torch.float64, 0, 300, 500, 100), (torch.float64, 1, 300, 302, 1),
    (torch.float64, 3, 7, 9, 0)]


@pytest.mark.parametrize("dtype, c0, w, lead, off", _STRIPE_CASES)
def test_cuda_stripe_write_matches_twin(cuda, dtype, c0, w, lead, off):
    gen = torch.Generator(device=cuda).manual_seed(3)
    dst = torch.randn((300, 1000), generator=gen, device=cuda, dtype=dtype)
    blk = torch.randn((300, lead), generator=gen, device=cuda, dtype=dtype)[:, off:off + w]
    _build.LAUNCHES.clear()
    got = cuda_chol.stripe_write(dst.clone(), blk, c0)
    assert _build.LAUNCHES["stripe_write"] == 1
    assert torch.equal(got, cuda_chol.stripe_write_reference(dst.clone(), blk, c0))


@pytest.mark.parametrize("c0", [0, 3])
def test_cuda_stripe_write_past_the_old_grid_cap(cuda, c0):
    # R = 70,000 rows (the old grid stopped at 65,535 and looped) of W = 8.
    gen = torch.Generator(device=cuda).manual_seed(18)
    dst = torch.randn((70000, 16), generator=gen, device=cuda)
    blk = torch.randn((70000, 8), generator=gen, device=cuda)
    got = cuda_chol.stripe_write(dst.clone(), blk, c0)
    assert torch.equal(got, cuda_chol.stripe_write_reference(dst.clone(), blk, c0))


@pytest.mark.parametrize("gen", ["value", "joint"])
def test_cuda_quad_band_matches_twin(cuda, gen):
    dtype = torch.float32
    rng = np.random.default_rng(19)
    x = torch.as_tensor(rng.normal(size=(256, 3)), dtype=dtype, device=cuda)
    params = kf.kernel_params(0.8, 1.0)
    cols = x if gen == "value" else cuda_joint.pack_meta(cuda_joint.joint_meta(x))
    n = cols.shape[0]
    w = torch.tril(torch.as_tensor(rng.normal(size=(n, n)), dtype=dtype, device=cuda))
    q = torch.as_tensor(rng.normal(size=(1000, 3)), dtype=dtype, device=cuda)
    for row0, r in ((0, 128), (n - 192, 192)):
        band = w[row0:row0 + r, :row0 + r]  # trimmed to its true width, a strided view
        got = cuda_query.quad_band(gen, "rbf", q, cols, params, band, row0)
        want = cuda_query.quad_band_reference(gen, "rbf", q.double(), cols.double(), params,
                                              band.double(), row0)
        _assert_quad_close(None, got, None, want, None, None)


def _scaled_tril(rng, rows, width, row0, dtype, dev, nonneg=False):
    """Rows [row0, row0 + rows) of a lower-triangular W, zero past each
    row's own global index, row i scaled by 1/sqrt(row0 + i + 1) so that
    every row tile carries a share of each query's quad."""
    g = rng.uniform(size=(rows, width)) if nonneg else rng.normal(size=(rows, width))
    w = np.tril(g, k=row0) / np.sqrt(np.arange(row0 + 1, row0 + rows + 1))[:, None]
    return torch.as_tensor(w, dtype=dtype, device=dev)


@pytest.mark.parametrize("m", [1, 127, 129, 1000])
@pytest.mark.parametrize("c", [1000, 1152])
def test_cuda_tc_quad_edge_shapes_match_f64_twin(cuda, m, c):
    """float32 D and F (value) at query counts around the 128-query tile and
    capacities off the 128-row tile (1,000; 1,152 = 9 tiles)."""
    rng = np.random.default_rng(m + c)
    x = torch.as_tensor(rng.normal(size=(c, 3)), dtype=torch.float32, device=cuda)
    q = torch.as_tensor(rng.normal(size=(m, 3)), dtype=torch.float32, device=cuda)
    params = kf.kernel_params(0.8, 1.0)
    w = _scaled_tril(rng, c, c, 0, torch.float32, cuda)
    alpha = torch.as_tensor(rng.normal(size=c), dtype=torch.float32, device=cuda)
    kq = cuda_query.stage_kq("rbf", q, x, params)
    mean_r, quad_r = cuda_query.staged_quad_reference(kq.double(), w.double(), alpha.double())
    _assert_quad_close(*cuda_query.staged_quad(kq, w, alpha), mean_r, quad_r, kq.double(),
                       alpha.double())
    kq64 = cuda_query.generated_kq("value", "rbf", q.double(), x.double(), params)
    mean_r, quad_r = cuda_query.staged_quad_reference(kq64, w.double(), alpha.double())
    _assert_quad_close(*cuda_query.fused_quad("value", "rbf", q, x, params, alpha, w), mean_r,
                       quad_r, kq64, alpha.double())


@pytest.mark.parametrize("gen", ["value", "joint"])
@pytest.mark.parametrize("row0, r", [(0, 300), (256, 128), (700, 300), (700, 1000)])
def test_cuda_tc_quad_band_edges_match_f64_twin(cuda, gen, row0, r):
    """float32 F band at row0 off the 32-deep chunk (700) and R off the
    128-row tile: the tile's bound carries row0, and W's stored zeros past
    each row's diagonal carry the rest of its last chunk."""
    rng = np.random.default_rng(row0 + r)
    n_pts = 600 if gen == "value" else 150
    x = torch.as_tensor(rng.normal(size=(n_pts, 3)), dtype=torch.float32, device=cuda)
    params = kf.kernel_params(0.8, 1.0)
    cols = x if gen == "value" else cuda_joint.pack_meta(cuda_joint.joint_meta(x))
    width = row0 + r
    cols = cols.repeat(-(-width // cols.shape[0]), 1)  # coincident columns past n_pts
    band = _scaled_tril(rng, r, width + 36, row0, torch.float32, cuda)[:, :width]  # strided
    q = torch.as_tensor(rng.normal(size=(700, 3)), dtype=torch.float32, device=cuda)
    got = cuda_query.quad_band(gen, "rbf", q, cols, params, band, row0)
    want = cuda_query.quad_band_reference(gen, "rbf", q.double(), cols.double(), params,
                                          band.double(), row0)
    _assert_quad_close(None, got, None, want, None, None)


def test_cuda_tc_quad_bias_on_nonnegative_operands(cuda):
    """float32 D on nonnegative W and kq: the mean relative error of the quad
    within 2e-8 (chip_smoke's bias gate; truncated steps would read ~1e-7
    low, squared)."""
    gen = torch.Generator(device=cuda).manual_seed(26)
    c, m = 4096, 2048
    w = torch.tril(torch.rand((c, c), generator=gen, device=cuda))
    kq = torch.rand((m, c), generator=gen, device=cuda)
    alpha = torch.rand((c,), generator=gen, device=cuda)
    _, quad = cuda_query.staged_quad(kq, w, alpha)
    _, quad_r = cuda_query.staged_quad_reference(kq.double(), w.double(), alpha.double())
    bias = ((quad.double() - quad_r) / quad_r).mean().item()
    assert abs(bias) <= 2e-8, bias


def test_cuda_tc_quad_repeats_bit_for_bit(cuda):
    """D and F twice each: the partials meet in a fixed order, no atomics."""
    rng = np.random.default_rng(27)
    c, m = 2048, 1000
    x = torch.as_tensor(rng.normal(size=(c, 3)), dtype=torch.float32, device=cuda)
    q = torch.as_tensor(rng.normal(size=(m, 3)), dtype=torch.float32, device=cuda)
    params = kf.kernel_params(0.8, 1.0)
    w = _scaled_tril(rng, c, c, 0, torch.float32, cuda)
    alpha = torch.as_tensor(rng.normal(size=c), dtype=torch.float32, device=cuda)
    kq = cuda_query.stage_kq("rbf", q, x, params)
    for run in (lambda: cuda_query.staged_quad(kq, w, alpha),
                lambda: cuda_query.fused_quad("value", "rbf", q, x, params, alpha, w),
                lambda: (cuda_query.quad_band("value", "rbf", q, x, params, w[1024:], 1024),)):
        first, second = run(), run()
        assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_cuda_tc_quad_gives_its_recorded_bits(cuda):
    """float32 D's (mean, quad) at M in {1, 127, 129, 1,000, 8,192} against
    C in {1,000, 1,152, 20,480} on fixed inputs: the sha256 of its bits
    against the one chip_smoke.py records (the lockstep body's), and each
    call made twice, bit for bit."""
    import chip_smoke

    digest, unstable = chip_smoke.tc_quad_digest(torch)
    assert not unstable, unstable
    assert digest == chip_smoke.TC_QUAD_SHA256


def test_cuda_tc_fused_quad_gives_its_recorded_bits(cuda):
    """float32 F's outputs, value and joint, on fixed inputs: fused_quad at
    M in {1, 127, 129, 1,000, 8,192} against C in {1,000, 1,152, 20,480},
    quad_band with R 300 at row0 0, 700 and 28,672; the sha256 of their
    bits against the one chip_smoke.py records (the lockstep body's), and
    each call made twice, bit for bit."""
    import chip_smoke

    digest, unstable = chip_smoke.tc_fused_quad_digest(torch)
    assert not unstable, unstable
    assert digest == chip_smoke.TC_FUSED_QUAD_SHA256


def test_cuda_tc_quad_refuses_a_view_tma_cannot_address(cuda):
    gen = torch.Generator(device=cuda).manual_seed(28)
    c, m = 512, 256
    x = torch.randn((c, 3), generator=gen, device=cuda)
    q = torch.randn((m, 3), generator=gen, device=cuda)
    params = kf.kernel_params(0.8, 1.0)
    alpha = torch.randn((c,), generator=gen, device=cuda)
    kq = cuda_query.stage_kq("rbf", q, x, params)
    # A contiguous W one float off a 16-byte boundary (D and F).
    w = torch.tril(torch.randn((c * c + 1,), generator=gen, device=cuda)[1:].view(c, c))
    w_off = torch.randn((c * c + 1,), generator=gen, device=cuda)[1:].view(c, c).copy_(w)
    with pytest.raises(ValueError, match="TMA"):
        cuda_query.staged_quad(kq, w_off, alpha)
    with pytest.raises(ValueError, match="TMA"):
        cuda_query.fused_quad("value", "rbf", q, x, params, alpha, w_off)
    # A band whose rows step by an odd count of floats, and one starting a
    # column off (F band).
    wide = torch.randn((256, 1023), generator=gen, device=cuda)
    with pytest.raises(ValueError, match="TMA"):
        cuda_query.quad_band("value", "rbf", q, x, params, wide[:, :512], 256)
    with pytest.raises(ValueError, match="TMA"):
        cuda_query.quad_band("value", "rbf", q, x, params, w[256:, 1:], 255)


@pytest.mark.parametrize("store", ["tiered", "host"])
def test_cuda_ooc_tiered_spill_matches_cpu(cuda, store):
    """A tiered store whose budget holds two panels, and a host store: the
    host spill, the copy-stream prefetch and the writer stream, float32 on
    the card against the CPU path in float64."""
    x = fibonacci_sphere(1000)
    y = np.random.default_rng(20).normal(size=1000) * 0.2
    q = np.random.default_rng(21).uniform(-1.2, 1.2, size=(3000, 3))
    params = kf.kernel_params(0.6, 1.0)
    out = []
    for dev, dt in ((cuda, torch.float32), ("cpu", torch.float64), ("cpu", torch.float32)):
        t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
        m = ooc.ooc_fit("rbf", t(x), t(y), 1e-3, params, panel=256, store=store,
                        device_budget=2 * 256 * 1024 * dt.itemsize)
        assert store == "host" or m.wstore.spilled()
        out.append([v.cpu().numpy() for v in ooc.ooc_predict(m, t(q), chunk=1024)])
    _assert_f32_close(*out)


@pytest.mark.parametrize("normals", [False, True])
def test_cuda_ooc_session_matches_cpu_session(cuda, normals):
    cfgs = _f32_f64(ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3,
                                n_external=127))
    pts = fibonacci_sphere(384 if normals else 896) * 1.3 + np.array([0.2, 0.0, -0.5])
    kw = {"normals": (pts - np.array([0.2, 0.0, -0.5])) / 1.3} if normals else {}
    _build.LAUNCHES.clear()
    sess = ObjectModelSession(cfgs["cuda"], device=cuda).start(pts, out_of_core=True, **kw)
    got = sess.evaluate_grid(16, 1.5)
    for name in ("gemm_nt_masked", "gemm_nn_acc_masked", "stripe_write", "quad_band",
                 "joint_cov" if normals else "gram_band"):
        assert _build.LAUNCHES[name] > 0, name
    want = ObjectModelSession(cfgs["cpu"], device="cpu").start(pts, out_of_core=True,
                                                               **kw).evaluate_grid(16, 1.5)
    _assert_f32_close(got, want)


def _lower_inv(gen, b, dtype):
    g = torch.randn((b, b), generator=gen, device=gen.device, dtype=dtype)
    ld = torch.linalg.cholesky(g @ g.T / b + torch.eye(b, dtype=dtype, device=gen.device))
    eye = torch.eye(b, dtype=dtype, device=gen.device)
    return torch.linalg.solve_triangular(ld, eye, upper=False).contiguous()


def test_cuda_panel_scale_matches_twin(cuda):
    # acc is the strided panel below a diagonal block, as in blocked_cholesky;
    # B = 200 is not a multiple of the 128 tile.
    gen = torch.Generator(device=cuda).manual_seed(4)
    a = torch.randn((900, 900), generator=gen, device=cuda)
    v = _lower_inv(gen, 200, torch.float32)
    _build.LAUNCHES.clear()
    got = cuda_chol.panel_scale(a[300:, 100:300], v)
    assert _build.LAUNCHES["panel_scale"] == 1
    want = cuda_chol.panel_scale_reference(a[300:, 100:300], v)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_cuda_row_scale_matches_twin(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    v = _lower_inv(gen, 192, torch.float32)
    rhs = torch.randn((192, 1200), generator=gen, device=cuda)[:, 100:1100]
    _build.LAUNCHES.clear()
    got = cuda_chol.row_scale(v, rhs)
    assert _build.LAUNCHES["row_scale"] == 1
    torch.testing.assert_close(got, cuda_chol.row_scale_reference(v, rhs), rtol=1e-4, atol=1e-4)


def _trail_tol(s, l_col, wj, j0, row0):
    """Float32 L against the float64 twin: 2e-6 x sum|a||b| of the worst live
    output plus 4 float32 ulps of max|S| (the values the product is
    subtracted from); 0 with no live row."""
    r, c = s.shape
    r_b, w = cuda_chol._trail_ranges(r, c, wj.shape[0], j0, row0)
    if r_b >= r:
        return 0.0
    return _tc_tol(l_col[r_b:], wj[:, :w]) + 4 * torch.finfo(torch.float32).eps * \
        s.abs().max().item()


@pytest.mark.parametrize("row0, j0", [(0, 0), (0, 256), (512, 0), (256, 512), (0, 960)])
def test_cuda_band_trail_matches_twin(cuda, row0, j0):
    # The tensor-core tile (NN, SUB_FROM in place).  (0, 960): no live row,
    # nothing launched.
    gen = torch.Generator(device=cuda).manual_seed(6)
    r, c, b = 512, 1024, 64
    s = torch.randn((r, c), generator=gen, device=cuda, dtype=torch.float64)
    l = torch.randn((r, c), generator=gen, device=cuda, dtype=torch.float64)
    wj = torch.randn((b, c), generator=gen, device=cuda, dtype=torch.float64)
    wj[:, j0 + b:] = 0.0
    s, l, wj = s.float(), l.float(), wj.float()
    want = cuda_chol.band_trail_reference(s.double().clone(), l[:, j0:j0 + b].double(),
                                          wj.double(), j0, row0)
    _build.LAUNCHES.clear()
    got = cuda_chol.band_trail(s.clone(), l[:, j0:j0 + b], wj, j0, row0)
    assert _build.LAUNCHES["band_trail"] == (0 if (row0, j0) == (0, 960) else 1)
    err = (got.double() - want).abs().max().item()
    assert err <= _trail_tol(s, l[:, j0:j0 + b], wj, j0, row0), err
    assert torch.equal(cuda_chol.band_trail(s.clone(), l[:, j0:j0 + b], wj, j0, row0), got)


@pytest.mark.parametrize("c, r, j0, row0", [(4096, 4096, 2048, 0), (4096, 1024, 1024, 1024),
                                            (4096, 1024, 1280, 1024), (1200, 300, 320, 300)])
def test_cuda_band_trail_leaves_s_outside_its_live_block(cuda, c, r, j0, row0):
    """Float32 L in place: S bit-identical above global row j0 + B and at
    columns >= j0 + B (counted here without `_trail_ranges`), the live block
    within the tile's gate.  P = 1 at chip_smoke's geometry scaled down,
    P = 4 bands from their first row and from inside, a ragged band."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    b = 256 if c == 4096 else 64
    s0 = torch.randn((r, c), generator=gen, device=cuda)
    l_col = torch.randn((r, c), generator=gen, device=cuda)[:, j0:j0 + b] / b**0.5
    wj = torch.randn((b, c), generator=gen, device=cuda)
    wj[:, j0 + b:] = 0.0
    got = cuda_chol.band_trail(s0.clone(), l_col, wj, j0, row0)
    dead = min(max(j0 + b - row0, 0), r)
    assert torch.equal(got[:dead], s0[:dead]) and torch.equal(got[:, j0 + b:], s0[:, j0 + b:])
    want = s0.double()
    want[dead:, :j0 + b] -= l_col[dead:].double() @ wj[:, :j0 + b].double()
    err = (got.double() - want).abs().max().item()
    assert err <= _trail_tol(s0, l_col, wj, j0, row0), err


def test_cuda_band_trail_bias_on_nonnegative_operands(cuda):
    """Nonnegative Lcol and Wj, S = 0: float32 L's mean relative error
    within chip_smoke's bias gate, 2e-8."""
    gen = torch.Generator(device=cuda).manual_seed(20)
    c, b, j0 = 4096, 256, 1024
    l_col = torch.rand((c, b), generator=gen, device=cuda)
    wj = torch.rand((b, c), generator=gen, device=cuda)
    wj[:, j0 + b:] = 0.0
    got = -cuda_chol.band_trail(torch.zeros((c, c), device=cuda), l_col, wj, j0, 0)
    prod = l_col[j0 + b:].double() @ wj[:, :j0 + b].double()
    assert abs(((got[j0 + b:, :j0 + b].double() - prod) / prod).mean().item()) <= 2e-8


def test_cuda_band_trail_refuses_a_view_tma_cannot_address(cuda):
    gen = torch.Generator(device=cuda).manual_seed(21)
    s = torch.zeros((512, 1024), device=cuda)
    l = torch.randn((512, 1024), generator=gen, device=cuda)
    wj = torch.randn((64, 1024), generator=gen, device=cuda)
    with pytest.raises(ValueError, match="TMA"):
        cuda_chol.band_trail(s, l[:, 1:65], wj, 256, 0)  # the panel one column off


def test_cuda_blocked_inv_factor_and_inverse(cuda):
    """float32 under panel_solve="inv" (Kernels J and K), held in float64 as
    test_cuda_tc_blocked_inv_route_float32."""
    a = torch.as_tensor(_spd(np.random.default_rng(22), 768), device=cuda)
    _build.LAUNCHES.clear()
    l = cuda_chol.blocked_cholesky(a.float(), 256, panel_solve="inv")
    w = cuda_chol.blocked_linv(l.clone(), 256, inplace=True, panel_solve="inv")
    assert _build.LAUNCHES["panel_scale"] == 2 and _build.LAUNCHES["row_scale"] == 3
    eye = torch.eye(768, dtype=torch.float64, device=cuda)
    assert (l.double() @ l.double().T - a).abs().max().item() < 1e-5
    assert (w.double() @ l.double() - eye).abs().max().item() < 1e-5


def test_cuda_one_rank_fit_sharded_matches_fit_inference(cuda, tmp_path):
    """A one-rank NCCL group at C = 4,096, float32: fit_sharded (Kernels A
    band, G, then A and F band in the query) against fit_inference in
    float64 on the CPU, and W again through Kernel L against the fit's."""
    import datetime

    import torch.distributed as dist

    from gpis_tpu_torch.gp import sharded_model
    from gpis_tpu_torch.linalg import sharded

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        x = fibonacci_sphere(4000)
        y = np.random.default_rng(23).normal(size=4000) * 0.2
        q = np.random.default_rng(24).uniform(-1.3, 1.3, (3001, 3))
        params = kf.kernel_params(0.5, 1.0)
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)  # noqa: E731
        _build.LAUNCHES.clear()
        model = sharded_model.fit_sharded("rbf", t(x), t(y), 1e-3, params, n_devices=1,
                                          block=256)
        got = regression.predict(model, t(q))
        for name in ("gram_band", "gemm_nt_masked", "cov", "quad_band"):
            assert _build.LAUNCHES[name] > 0, name
        want, own = (regression.predict(regression.fit_inference(
            "rbf", torch.as_tensor(x, dtype=dt), torch.as_tensor(y, dtype=dt), 1e-3, params,
            block=256), torch.as_tensor(q, dtype=dt)) for dt in (torch.float64, torch.float32))
        _assert_f32_close([v.cpu() for v in got], want, own)
        w_k = sharded.sharded_linv(model.l, model.mesh, block=256, use_kernel=True)
        assert _build.LAUNCHES["band_trail"] > 0
        # chip_smoke.py's SHARDED_W_GAP, relative to max|W|.
        assert (w_k - model.w).abs().max().item() <= 1e-3 * model.w.abs().max().item()
    finally:
        dist.destroy_process_group()


# ---- float32 C and H: the split-TF32 tensor-core body (csrc/tc_nn.cuh) ----
# Held to the twin run in float64: |err| <= 2e-6 x sum|a||b| of the worst
# output (split products ~2^-22 relative, FP32 step sums), and for H plus 4
# float32 ulps of max|U|, the old values the product lands on.


def _tc_tol(a, b):
    return 2e-6 * (a.double().abs() @ b.double().abs()).max().item()


@pytest.mark.parametrize("j0, bw", [(256, 256), (700, 200), (8192, 256)])
def test_cuda_tc_row_update_matches_f64_twin(cuda, j0, bw):
    # bw 200: ragged rows; j0 700: a ragged k range and a tile straddling j0.
    gen = torch.Generator(device=cuda).manual_seed(7)
    n = 256 * (j0 // 256 + 2)
    w = torch.tril(torch.randn((n, n), generator=gen, device=cuda)) / j0**0.5
    l_row = torch.randn((bw, n), generator=gen, device=cuda)
    _build.LAUNCHES.clear()
    got = cuda_chol.row_update(w, l_row, j0)
    assert _build.LAUNCHES["row_update"] == 1
    want = cuda_chol.row_update_reference(w.double(), l_row.double(), j0)
    err = (got.double() - want).abs().max().item()
    assert err <= _tc_tol(l_row[:, :j0], w[:j0, :j0]), err
    assert torch.equal(got[:, j0:], torch.zeros_like(got[:, j0:]))
    assert torch.equal(cuda_chol.row_update(w, l_row, j0), got)  # bit-identical rerun


@pytest.mark.parametrize("r, k, w, width", [(200, 384, 300, 640), (200, 384, 640, 640),
                                            (2048, 256, 2304, 2304), (256, 1000, 1024, 1280)])
def test_cuda_tc_gemm_nn_acc_masked_matches_f64_twin(cuda, r, k, w, width):
    # (200, ..): ragged rows, few tiles (split-K); (2048, 256, 2304): 288
    # tiles, over two waves of 132 (no split); k 1000: a ragged k range;
    # w below and at the width.
    gen = torch.Generator(device=cuda).manual_seed(8)
    lj = torch.randn((r, k + 256), generator=gen, device=cuda) / k**0.5
    a = lj[:, 256:256 + k]  # a strided column slice, as the k-step's
    b = torch.randn((k, width), generator=gen, device=cuda)
    u = torch.randn((r, width), generator=gen, device=cuda)
    _build.LAUNCHES.clear()
    got = cuda_chol.gemm_nn_acc_masked(u.clone(), a, b, w)
    assert _build.LAUNCHES["gemm_nn_acc_masked"] == 1
    want = cuda_chol.gemm_nn_acc_masked_reference(u.double(), a.double(), b.double(), w)
    err = (got.double() - want).abs().max().item()
    tol = _tc_tol(a, b[:, :w]) + 4 * torch.finfo(torch.float32).eps * u.abs().max().item()
    assert err <= tol, err
    assert torch.equal(got[:, w:], u[:, w:])  # columns >= w untouched
    assert torch.equal(cuda_chol.gemm_nn_acc_masked(u.clone(), a, b, w), got)


def test_cuda_tc_trsm_finish_alias_case_matches_f64_twin(cuda):
    """H reads rows < r0 of the buffer whose rows [r0, r0 + 256) it writes."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    rows, c, r0, block = 1024, 1536, 512, 256
    width = 1280
    ljj = torch.randn((rows, rows), generator=gen, device=cuda) / rows**0.5
    u = torch.randn((rows, c), generator=gen, device=cuda)
    a = -ljj[r0:r0 + block, :r0]
    got = u.clone()
    cuda_chol.gemm_nn_acc_masked(got[r0:r0 + block, :width], a, got[:r0], width)
    want = u.double()
    want[r0:r0 + block, :width] += a.double() @ want[:r0, :width]
    err = (got.double() - want).abs().max().item()
    tol = _tc_tol(a, u[:r0, :width]) + 4 * torch.finfo(torch.float32).eps * u.abs().max().item()
    assert err <= tol, err
    assert torch.equal(got[:r0], u[:r0]) and torch.equal(got[r0 + block:], u[r0 + block:])
    assert torch.equal(got[:, width:], u[:, width:])


def test_cuda_tc_refuses_a_view_tma_cannot_address(cuda):
    gen = torch.Generator(device=cuda).manual_seed(10)
    lj = torch.randn((256, 520), generator=gen, device=cuda)
    b = torch.randn((256, 512), generator=gen, device=cuda)
    u = torch.zeros((256, 512), device=cuda)
    with pytest.raises(ValueError, match="TMA"):
        cuda_chol.gemm_nn_acc_masked(u, lj[:, 1:257], b, 512)  # one column off
    # A contiguous W one float off a 16-byte boundary.
    w = torch.randn((512 * 512 + 1,), generator=gen, device=cuda)[1:].view(512, 512)
    with pytest.raises(ValueError, match="TMA"):
        cuda_chol.row_update(w, torch.randn((256, 512), device=cuda), 256)


def test_cuda_tc_blocked_linv_float32(cuda):
    """The in-core TRSM through the tensor-core C: W L = I to float32's
    conditioning of a well-conditioned factor."""
    a = torch.as_tensor(_spd(np.random.default_rng(25), 1024), dtype=torch.float32, device=cuda)
    l = torch.linalg.cholesky(a).contiguous()  # the library's factor is column-major
    _build.LAUNCHES.clear()
    w = cuda_chol.blocked_linv(l.clone(), 256, inplace=True)
    assert _build.LAUNCHES["row_update"] == 3
    res = (w.double() @ l.double() - torch.eye(1024, dtype=torch.float64, device=cuda))
    assert res.abs().max().item() < 1e-5


# B and G in float32: the NT layout of the same tensor-core kernel, held to
# the twin run in float64 at 2e-6 x sum|a||b| plus 4 float32 ulps of max|S|
# (the values the product is subtracted from).


@pytest.mark.parametrize("n, j0, bw", [(1024, 256, 256), (2048, 700, 200), (8704, 8192, 256),
                                       (16384, 8192, 256)])
def test_cuda_tc_panel_update_matches_f64_twin_in_place(cuda, n, j0, bw):
    # (2048, 700, 200): a ragged k range and ragged columns; (8704, 8192):
    # 4 row tiles, split-K; (16384, 8192): 128 tiles, split-K.
    gen = torch.Generator(device=cuda).manual_seed(11)
    m = torch.randn((n, n), generator=gen, device=cuda) / j0**0.5
    a, b, s = m[j0:, :j0], m[j0:j0 + bw, :j0], m[j0:, j0:j0 + bw]
    _build.LAUNCHES.clear()
    got = cuda_chol.panel_update(m.clone(), j0, bw)
    assert _build.LAUNCHES["panel_update"] == 1
    want = s.double() - a.double() @ b.double().T
    err = (got[j0:, j0:j0 + bw].double() - want).abs().max().item()
    tol = _tc_tol(a, b.T) + 4 * torch.finfo(torch.float32).eps * s.abs().max().item()
    assert err <= tol, err
    assert torch.equal(got[:j0], m[:j0]) and torch.equal(got[j0:, :j0], a)
    assert torch.equal(got[j0:, j0 + bw:], m[j0:, j0 + bw:])
    assert torch.equal(cuda_chol.panel_update(m.clone(), j0, bw), got)  # bit-identical rerun


@pytest.mark.parametrize("r, p, k0, lead", [(320, 200, 0, 1000), (320, 200, 300, 1000),
                                            (320, 200, 700, 1000), (2048, 2304, 1024, 4096),
                                            (200, 384, 896, 1280)])
def test_cuda_tc_gemm_nt_masked_matches_f64_twin(cuda, r, p, k0, lead):
    # The k-step's operands: the band, a trimmed panel, a stripe of the band
    # as S.  k0 0: no unit, out is a copy of S; (2048, 2304): 288 tiles, no
    # split; the rest split-K, ragged rows, columns or k.
    gen = torch.Generator(device=cuda).manual_seed(12)
    cur = torch.randn((r, lead), generator=gen, device=cuda) / max(k0, 1) ** 0.5
    lk = torch.randn((p, lead), generator=gen, device=cuda) / max(k0, 1) ** 0.5
    s = cur[:, lead - p:]
    _build.LAUNCHES.clear()
    got = cuda_chol.gemm_nt_masked(cur, lk, s, k0)
    assert _build.LAUNCHES["gemm_nt_masked"] == 1
    if k0 == 0:
        assert torch.equal(got, s)
    want = s.double() - cur[:, :k0].double() @ lk[:, :k0].double().T
    err = (got.double() - want).abs().max().item()
    ulps = 4 * torch.finfo(torch.float32).eps * s.abs().max().item()
    tol = _tc_tol(cur[:, :k0], lk[:, :k0].T) + ulps
    assert err <= tol, err
    assert torch.equal(cuda_chol.gemm_nt_masked(cur, lk, s, k0), got)


def test_cuda_tc_nt_bias_with_a_is_b(cuda):
    """Nonnegative operands, a = b, S = 0: B on a panel of one matrix and G
    at the out-of-core diagonal block's shape (a = b = the band); the mean
    relative error within chip_smoke's bias gate, 2e-8."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    n, j0, bw = 4096, 2048, 256
    m = torch.rand((n, n), generator=gen, device=cuda)
    m[:, j0:j0 + bw] = 0.0
    prod = m[j0:, :j0].double() @ m[j0:j0 + bw, :j0].double().T
    acc = -cuda_chol.panel_update(m, j0, bw)[j0:, j0:j0 + bw]
    assert abs(((acc.double() - prod) / prod).mean().item()) <= 2e-8
    r, k0 = 2048, 4096
    cur = torch.rand((r, k0 + r), generator=gen, device=cuda)
    cur[:, k0:] = 0.0
    acc = -cuda_chol.gemm_nt_masked(cur, cur, cur[:, k0:], k0)
    prod = cur[:, :k0].double() @ cur[:, :k0].double().T
    assert abs(((acc.double() - prod) / prod).mean().item()) <= 2e-8


def test_cuda_tc_nt_refuses_a_view_tma_cannot_address(cuda):
    gen = torch.Generator(device=cuda).manual_seed(14)
    cur = torch.randn((256, 520), generator=gen, device=cuda)
    lk = torch.randn((256, 512), generator=gen, device=cuda)
    with pytest.raises(ValueError, match="TMA"):
        cuda_chol.gemm_nt_masked(cur[:, 1:257], lk, cur[:, 260:516], 256)  # one column off
    # B's matrix with rows of 1,026 floats: not a multiple of 16 bytes.
    m = torch.randn((1026, 1026), generator=gen, device=cuda)
    with pytest.raises(ValueError, match="TMA"):
        cuda_chol.panel_update(m, 512, 256)


# J and K in float32: the tile's NT (J) and NN (K) layouts with the STORE
# epilogue, each tile over k up to its last column (J) or row (K) of the
# lower-triangular V; held to the twin run in float64 at 2e-6 x sum|a||b|.


@pytest.mark.parametrize("n, j0, b", [(4096, 0, 256), (4096, 3584, 256), (1200, 200, 200),
                                      (16384, 0, 256)])
def test_cuda_tc_panel_scale_matches_f64_twin(cuda, n, j0, b):
    # j0 0: the factor's first, deepest step (R = n - b); 3584: its last
    # (R = 256); B 200: ragged columns and k; (16384, 0): R 16,128, 252 units.
    gen = torch.Generator(device=cuda).manual_seed(15)
    a = torch.randn((n, n), generator=gen, device=cuda)
    v = _lower_inv(gen, b, torch.float32)
    acc = a[j0 + b:, j0:j0 + b]  # the strided panel below block j0
    torch.full((n - j0 - b, b), float("nan"), device=cuda)  # STORE must read none of out
    _build.LAUNCHES.clear()
    got = cuda_chol.panel_scale(acc, v)
    assert _build.LAUNCHES["panel_scale"] == 1
    err = (got.double() - acc.double() @ v.double().T).abs().max().item()
    assert err <= _tc_tol(acc, v.T), err
    assert torch.equal(cuda_chol.panel_scale(acc, v), got)  # bit-identical rerun


@pytest.mark.parametrize("b, n", [(256, 4096), (256, 256), (192, 1000), (256, 16384)])
def test_cuda_tc_row_scale_matches_f64_twin(cuda, b, n):
    # N 4,096: the TRSM's last step at C = 4,096; 256: its first; B 192:
    # ragged rows and k; N 16,384: 256 units.
    gen = torch.Generator(device=cuda).manual_seed(16)
    v = _lower_inv(gen, b, torch.float32)
    rhs = torch.randn((b, n), generator=gen, device=cuda)
    torch.full((b, n), float("nan"), device=cuda)
    _build.LAUNCHES.clear()
    got = cuda_chol.row_scale(v, rhs)
    assert _build.LAUNCHES["row_scale"] == 1
    err = (got.double() - v.double() @ rhs.double()).abs().max().item()
    assert err <= _tc_tol(v, rhs), err
    assert torch.equal(cuda_chol.row_scale(v, rhs), got)


def test_cuda_tc_inv_bias_on_nonnegative_operands(cuda):
    """A nonnegative lower-triangular V and nonnegative panels: J's and K's
    mean relative error within chip_smoke's bias gate, 2e-8."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    v = torch.rand((256, 256), generator=gen, device=cuda).tril_()
    acc = torch.rand((4096, 256), generator=gen, device=cuda)
    prod = acc.double() @ v.double().T
    got = cuda_chol.panel_scale(acc, v)
    assert abs(((got.double() - prod) / prod).mean().item()) <= 2e-8
    rhs = torch.rand((256, 4096), generator=gen, device=cuda)
    prod = v.double() @ rhs.double()
    got = cuda_chol.row_scale(v, rhs)
    assert abs(((got.double() - prod) / prod).mean().item()) <= 2e-8


def test_cuda_tc_blocked_inv_route_float32(cuda):
    """The in-core factor and TRSM under panel_solve="inv" with J and K on
    the tile: L L^T = A and W L = I to float32's conditioning."""
    a = torch.as_tensor(_spd(np.random.default_rng(26), 1024), dtype=torch.float32, device=cuda)
    _build.LAUNCHES.clear()
    l = cuda_chol.blocked_cholesky(a.clone(), 256, panel_solve="inv")
    w = cuda_chol.blocked_linv(l.clone(), 256, inplace=True, panel_solve="inv")
    assert _build.LAUNCHES["panel_scale"] == 3 and _build.LAUNCHES["row_scale"] == 4
    eye = torch.eye(1024, dtype=torch.float64, device=cuda)
    assert (l.double() @ l.double().T - a.double()).abs().max().item() < 1e-5
    assert (w.double() @ l.double() - eye).abs().max().item() < 1e-5


# ------------------------------------------------------------ config 3

F32_GRAD_REL = 1e-3  # chip_smoke.py's: a float32 gradient against float64, norm-wise


def _mll_grads(device, dtype, x, y, noise):
    """The MLL and its gradient in (lengthscale, signal variance, noise) on
    `device`, in `dtype`."""
    ls = torch.tensor(0.5, dtype=dtype, device=device, requires_grad=True)
    sv = torch.tensor(1.1, dtype=dtype, device=device, requires_grad=True)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    nz = t(noise).requires_grad_(True)
    mll = regression.log_marginal_likelihood(
        "rbf", t(x), t(y), nz, {"lengthscale": ls, "signal_variance": sv}, n_real=4000)
    grads = torch.autograd.grad(mll, (ls, sv, nz))
    return [mll.detach().cpu().numpy()] + [g.cpu().numpy() for g in grads]


def test_cuda_mll_gradient_matches_cpu(cuda):
    """At C = 4,096 the MLL's Gram is Kernel A under `gram_ad` and its
    factor Kernel B under `blocked_cholesky_ad`; value and gradient in
    float32 held to the CPU path in float64 (the twins and the library
    factor): each within F32_GRAD_REL of its largest entry, or F32_OWN
    times the CPU's float32 gap where that is larger."""
    rng = np.random.default_rng(31)
    x = rng.uniform(-1.0, 1.0, size=(4096, 3))
    y = rng.normal(size=4096) * 0.3
    noise = rng.uniform(1e-2, 2e-2, size=4096)
    _build.LAUNCHES.clear()
    got = _mll_grads(cuda, torch.float32, x, y, noise)
    assert _build.LAUNCHES["cov"] == 1 and _build.LAUNCHES["panel_update"] == 15
    want, own = (_mll_grads("cpu", dt, x, y, noise) for dt in (torch.float64, torch.float32))
    for g, w, o in zip(got, want, own):
        assert _gap(g, w) <= max(F32_GRAD_REL * np.abs(w).max(), F32_OWN * _gap(o, w))


@pytest.mark.parametrize("out_of_core, method", [(False, "subsample"), (True, "stream")])
def test_cuda_session_hyperopt_matches_cpu_session(cuda, out_of_core, method):
    cfgs = _f32_f64(ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3,
                                n_external=127, touch_capacity=0))
    pts = fibonacci_sphere(896) * 1.3 + np.array([0.2, 0.0, -0.5])
    sessions = [ObjectModelSession(c, device=d).start(pts, out_of_core=out_of_core)
                for d, c in cfgs.items()]
    got, want = (s.optimize_hyperparameters(method=method, steps=3) for s in sessions)
    hist = np.asarray(want.history)
    assert np.abs(np.asarray(got.history) - hist).max() <= F32_GRAD_REL * np.abs(hist).max()
    _assert_f32_close(*(s.evaluate_grid(16, 1.5) for s in sessions))


def test_cuda_registered_kernel_takes_the_twins(cuda):
    """A registered covariance has no CUDA body: the session fits and
    queries it on the card through the covariance's plain twin, as on the
    CPU."""
    kf.register_kernel("rq2_card", k_r2=lambda r2, p: p["signal_variance"] * (
        1.0 + r2 / (4.0 * p["lengthscale"] ** 2)) ** -2.0, k_diag0=lambda p: p["signal_variance"])
    try:
        cfgs = _f32_f64(ModelConfig(kernel="rq2_card", lengthscale=0.4, noise_surface=1e-3,
                                    n_external=127, touch_capacity=0))
        pts = fibonacci_sphere(896) * 1.3 + np.array([0.2, 0.0, -0.5])
        _build.LAUNCHES.clear()
        got = ObjectModelSession(cfgs["cuda"], device=cuda).start(pts).evaluate_grid(16, 1.5)
        assert _build.LAUNCHES["cov"] == 0 and _build.LAUNCHES["fused_quad"] == 0
        want = ObjectModelSession(cfgs["cpu"], device="cpu").start(pts).evaluate_grid(16, 1.5)
        _assert_f32_close(got, want)
    finally:
        kf.unregister_kernel("rq2_card")


# The tensor-core kernels' wrappers, each with arguments on float64 operands
# (a function, so that an in-place wrapper gets fresh copies).
def _float64_wrapper_cases(dev):
    gen = torch.Generator(device=dev).manual_seed(29)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)

    m, w, v, q, x, alpha = r(512, 512), torch.tril(r(512, 512)), r(128, 128).tril(), \
        r(300, 3), r(512, 3), r(512)
    params = kf.kernel_params(0.8, 1.0)
    return {
        "panel_update": (cuda_chol, lambda: (m.clone(), 256, 128)),
        "row_update": (cuda_chol, lambda: (w, m[:128], 256)),
        "gemm_nt_masked": (cuda_chol, lambda: (m, m[:200], m[:, 300:500], 256)),
        "gemm_nn_acc_masked": (cuda_chol, lambda: (m.clone(), m[:, :128], m[:128], 300)),
        "panel_scale": (cuda_chol, lambda: (m[:, :128], v)),
        "row_scale": (cuda_chol, lambda: (v, m[:128])),
        "band_trail": (cuda_chol, lambda: (m.clone(), m[:, 128:256], w[128:256], 128, 0)),
        "staged_quad": (cuda_query, lambda: (m[:300], w, alpha)),
        "fused_quad": (cuda_query, lambda: ("value", "rbf", q, x, params, alpha, w)),
        "quad_band": (cuda_query, lambda: ("value", "rbf", q, x, params, w[256:384, :384], 256)),
    }


@pytest.mark.parametrize("name", ["panel_update", "row_update", "gemm_nt_masked",
                                  "gemm_nn_acc_masked", "panel_scale", "row_scale", "band_trail",
                                  "staged_quad", "fused_quad", "quad_band"])
def test_cuda_tensor_core_kernels_refuse_float64(cuda, name):
    """B, C, D, F, G, H, J, K and L take float32 only: on float64 card
    tensors each wrapper raises and launches nothing (float64 runs on the
    CPU, where each takes its twin)."""
    module, args = _float64_wrapper_cases(cuda)[name]
    _build.LAUNCHES.clear()
    with pytest.raises(TypeError, match="float64"):
        getattr(module, name)(*args())
    assert not _build.LAUNCHES


def test_cuda_float64_session_is_refused(cuda):
    with pytest.raises(ValueError, match="float32"):
        ObjectModelSession(ModelConfig(dtype="float64"), device=cuda)
