"""The second half of the port's out-of-core pipeline against the JAX
package's, on the CPU in float64: the two phases (`ooc_factor_phase`,
`ooc_solve_phase`) with their crash resumes and refusals, the joint
phases, the int16 L codec and its guard `ooc_residual_check`, the
TRSM-fused query, the deferred alpha, the float16 W, `plan_sweeps` and the
split stream objective (`ooc_mll_and_grad_solve_phase`), one for one after
tests/test_outofcore.py:140-1490 and tests/test_ooc_hyperopt.py:216-275.

Each test runs both packages on the same inputs and holds the port to JAX
at 1e-6 on posterior mean and variance (BASELINE.md row 2; the objective at
the JAX tests' rtol 1e-9 and 1e-7), and to the dense in-core fit where the
JAX test does.  The int16 codec takes the same codes from both packages
(held bit for bit), so its fits are held to JAX at 1e-6 too, and to the
dense fit at the JAX tests' own grade.  A float16 W entry whose float64
value differs between the packages by a rounding can land one float16 step
away (~5e-4 relative), so the float16 W's variance is held to JAX at 1e-3
(read: 5.3e-6 with the spilled panels narrowed, 1.6e-4 with all of W
narrowed; the dense fit is 5e-2 away at that grade) and its mean, which W
never reaches, at 1e-6.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu.config import ModelConfig as JaxModelConfig
from gpis_tpu.data import gpis as jgpis
from gpis_tpu.gp import ooc_hyperopt as joho
from gpis_tpu.gp import regression as jgpr
from gpis_tpu.kernels import functions as jkf
from gpis_tpu.linalg import outofcore as jooc
from gpis_tpu_torch.gp import ooc_hyperopt as oho
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.linalg import outofcore as ooc

C, PANEL, BLOCK = 512, 128, 64
LS, SV = 0.7, 1.1
TOL = 1e-6
BUDGET = 2 * PANEL * C * 8  # two full-width float64 panels: the rest spills
F16_VAR_TOL = 1e-3  # a float16 W's variance across the packages (module note)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the module: these sizes gain nothing from
    more, and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _params(ls=LS, sv=SV):
    return kf.kernel_params(ls, sv), jkf.kernel_params(ls, sv)


@pytest.fixture(scope="module")
def problem():
    """tests/test_outofcore.py's random value problem, at C = 512."""
    rng = np.random.default_rng(91)
    x = rng.normal(size=(C, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return (x, rng.normal(size=C) * 0.3, rng.uniform(1e-4, 1e-2, size=C),
            rng.normal(size=(96, 3)) * 0.8)


@pytest.fixture(scope="module")
def gpis_problem():
    """A structured GPIS problem (smooth labels, calibrated noise): the
    int16 codec's supported regime (tests/test_outofcore.py:1198)."""
    cfg = JaxModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=63,
                         n_internal=1, block=64, touch_capacity=0)
    ts = jgpis.build_training_set(jgpis.fibonacci_sphere(448, radius=1.0), cfg)
    return (np.asarray(ts.x), np.asarray(ts.y), np.asarray(ts.noise),
            np.random.default_rng(5).normal(size=(96, 3)) * 0.8)


def _factor(pkg, x, y, noise, sd, **kw):
    p, jp = _params(kw.pop("ls", LS), kw.pop("sv", SV))
    if pkg is ooc:
        for k in ("normals", "noise_g"):
            if k in kw:
                kw[k] = _t(kw[k])
        ooc.ooc_factor_phase("rbf", _t(x), _t(y), _t(noise), p, panel=PANEL, block=BLOCK,
                             spill_dir=sd, **kw)
    else:
        for k in ("normals", "noise_g"):
            if k in kw:
                kw[k] = _j(kw[k])
        jooc.ooc_factor_phase("rbf", _j(x), _j(y), _j(noise), jp, panel=PANEL, block=BLOCK,
                              spill_dir=sd, **kw)


def _solve(pkg, sd, **kw):
    if pkg is ooc:
        return ooc.ooc_solve_phase(sd, device="cpu", **kw)
    if "fused_query" in kw:
        kw["fused_query"] = _j(kw["fused_query"])
    return jooc.ooc_solve_phase(sd, **kw)


def _predict(m, q):
    if isinstance(m, (ooc.OOCModel,)):
        return [v.numpy() for v in m.predict(_t(q))]
    return [np.asarray(v) for v in m.predict(_j(q), chunk=q.shape[0])]


def _close(a, b, atol=TOL):
    for u, v in zip(a, b):
        np.testing.assert_allclose(np.asarray(u), np.asarray(v), atol=atol)


def _dense(x, y, noise, q, ls=LS, sv=SV):
    ref = jgpr.fit("rbf", _j(x), _j(y), _j(noise), jkf.kernel_params(ls, sv), block=PANEL,
                   touch_capacity=0)
    return [np.asarray(v) for v in jgpr.predict(ref, _j(q))]


def _both_phases(tmp_path, problem, tag, factor_kw=None, solve_kw=None):
    x, y, noise, q = problem
    out = []
    for pkg in (ooc, jooc):
        sd = str(tmp_path / f"{tag}_{pkg.__name__.split('.')[0]}")
        _factor(pkg, x, y, noise, sd, **(factor_kw or {}))
        out.append(_solve(pkg, sd, **(solve_kw or {})))
    return out


# --------------------------------------------------------- the two phases


def test_phase_split_roundtrip_matches_jax(problem, tmp_path):
    """tests/test_outofcore.py:237: factor and alpha persisted, the TRSM
    reattached from the manifest, the posterior of the one-call fit."""
    x, y, noise, q = problem
    m, jm = _both_phases(tmp_path, problem, "split", {"device_budget": BUDGET},
                         {"device_budget": BUDGET})
    assert m.capacity == C and m.n_real == C
    assert sorted(os.listdir(tmp_path / "split_gpis_tpu_torch")) == ["L", "W", "state.npz"]
    got = _predict(m, q)
    _close(got, _predict(jm, q))
    _close(got, _dense(x, y, noise, q))
    np.testing.assert_allclose(m.log_marginal_likelihood(), jm.log_marginal_likelihood(),
                               rtol=1e-9)


def _dying_diag(monkeypatch, after: int = 2):
    """Make the factor's third diagonal step raise, as a kill would."""
    calls = {"n": 0}
    real = ooc._chol_diag

    def dying(cur, j0, *, block):
        calls["n"] += 1
        if calls["n"] > after:
            raise RuntimeError("simulated mid-factorization kill")
        return real(cur, j0, block=block)

    monkeypatch.setattr(ooc, "_chol_diag", dying)
    return real


def _spy(monkeypatch, name: str) -> dict:
    seen = {}
    real = getattr(ooc, name)

    def spying(*a, **kw):
        seen["panel"] = kw.get("start_panel", 0)
        return real(*a, **kw)

    monkeypatch.setattr(ooc, name, spying)
    return seen


def test_factor_phase_resumes_after_crash(problem, tmp_path, monkeypatch):
    """tests/test_outofcore.py:256: killed after its first stored sweeps,
    the factor resumes from the progress checkpoint, not from panel 0, and
    gives JAX's posterior and the exact MLL."""
    x, y, noise, q = problem
    sd = str(tmp_path / "crash")
    real = _dying_diag(monkeypatch)
    with pytest.raises(RuntimeError, match="simulated"):
        _factor(ooc, x, y, noise, sd, device_budget=BUDGET, sweep=1)
    monkeypatch.setattr(ooc, "_chol_diag", real)
    with np.load(os.path.join(sd, "progress.npz")) as d:
        assert int(d["next_panel"]) >= 1
    seen = _spy(monkeypatch, "ooc_cholesky")
    _factor(ooc, x, y, noise, sd, device_budget=BUDGET, sweep=1)
    assert seen["panel"] >= 1, "the resume did not skip the stored panels"
    assert not os.path.exists(os.path.join(sd, "progress.npz"))
    m = _solve(ooc, sd, device_budget=BUDGET)
    jsd = str(tmp_path / "crash_jax")
    _factor(jooc, x, y, noise, jsd, device_budget=BUDGET, sweep=1)
    jm = _solve(jooc, jsd, device_budget=BUDGET)
    _close(_predict(m, q), _predict(jm, q))
    want = float(jgpr.log_marginal_likelihood("rbf", jm.x, jm.y, jm.noise, jm.params,
                                              n_real=jm.n_real))
    np.testing.assert_allclose(m.log_marginal_likelihood(), want, rtol=1e-9)


@pytest.mark.parametrize("change", ["params", "y"])
def test_factor_resume_refuses_another_problem(change, problem, tmp_path, monkeypatch):
    """tests/test_outofcore.py:312 and :512: a checkpoint of another Gram
    (other hyperparameters) or other targets (u = L^{-1} y is in it) is not
    resumed: the factor starts at panel 0 and answers for the new problem."""
    x, y, noise, q = problem
    sd = str(tmp_path / f"stale_{change}")
    real = _dying_diag(monkeypatch)
    with pytest.raises(RuntimeError):
        _factor(ooc, x, y, noise, sd, device_budget=BUDGET, sweep=1)
    monkeypatch.setattr(ooc, "_chol_diag", real)
    assert os.path.exists(os.path.join(sd, "progress.npz"))
    seen = _spy(monkeypatch, "ooc_cholesky")
    kw = {"ls": 0.9, "sv": 1.3} if change == "params" else {}
    y2 = -2.0 * y + 0.1 if change == "y" else y
    _factor(ooc, x, y2, noise, sd, device_budget=BUDGET, sweep=1, **kw)
    assert seen["panel"] == 0, "a checkpoint of another problem was resumed"
    m = _solve(ooc, sd, device_budget=BUDGET)
    _close(_predict(m, q), _dense(x, y2, noise, q, kw.get("ls", LS), kw.get("sv", SV)))


def test_solve_phase_resumes_after_crash(problem, tmp_path, monkeypatch):
    """tests/test_outofcore.py:396: stopped after one stored W panel (L
    panel 0 consumed, its file gone), the TRSM resumes at panel 1."""
    x, y, noise, q = problem
    sd = str(tmp_path / "trsm_crash")
    _factor(ooc, x, y, noise, sd, device_budget=BUDGET)
    assert _solve(ooc, sd, device_budget=BUDGET, stop_after=1) is None
    assert os.path.exists(os.path.join(sd, "W", "manifest.json"))
    assert os.path.exists(os.path.join(sd, "W", "panel_0.bin"))
    assert not os.path.exists(os.path.join(sd, "L", "panel_0.bin"))
    seen = _spy(monkeypatch, "ooc_trsm")
    m = _solve(ooc, sd, device_budget=BUDGET)
    assert seen["panel"] == 1, "the resume did not skip the stored W panel"
    _close(_predict(m, q), _dense(x, y, noise, q))


def test_solve_refuses_a_stale_w_store(problem, tmp_path, monkeypatch):
    """tests/test_outofcore.py:561: after a refit in place (other
    hyperparameters, same shapes), the W store of the old factor is not
    resumed."""
    x, y, noise, q = problem
    sd = str(tmp_path / "stale_w")
    _factor(ooc, x, y, noise, sd, device_budget=BUDGET)
    _solve(ooc, sd, device_budget=BUDGET)
    _factor(ooc, x, y, noise, sd, device_budget=BUDGET, ls=0.9, sv=1.3)
    seen = _spy(monkeypatch, "ooc_trsm")
    m = _solve(ooc, sd, device_budget=BUDGET)
    assert seen["panel"] == 0, "a stale W store was resumed"
    _close(_predict(m, q), _dense(x, y, noise, q, 0.9, 1.3))


def test_trsm_refuses_a_partial_alpha_and_a_ragged_block():
    """tests/test_outofcore.py:362, both packages."""
    y = torch.zeros(512, dtype=torch.float64)
    for pkg, st, yy, kw in ((ooc, lambda: ooc.HostPanelStore("cpu"), y, {}),
                            (jooc, jooc.HostPanelStore, jnp.zeros(512), {})):
        with pytest.raises(ValueError, match="sub-range"):
            pkg.ooc_trsm(st(), st(), yy, panel=256, accumulate_alpha=True, end_panel=1)
        with pytest.raises(ValueError, match="multiple of"):
            pkg.ooc_trsm(st(), st(), yy, panel=128, block=256, accumulate_alpha=False)


def test_solve_phase_missing_l_fails_fast(problem, tmp_path):
    """tests/test_outofcore.py:949: a TRSM whose L panels an earlier TRSM
    consumed (its W store cleared since) raises at once, with the fix."""
    x, y, noise, _ = problem
    sd = str(tmp_path / "gone")
    _factor(ooc, x, y, noise, sd, device_budget=BUDGET)
    _solve(ooc, sd, device_budget=BUDGET).wstore.clear()
    with pytest.raises(FileNotFoundError, match="run the factor phase again"):
        _solve(ooc, sd, device_budget=BUDGET)


def test_joint_phases_match_jax_and_the_one_call_fit(tmp_path):
    """tests/test_outofcore.py:1147: the joint phases (normals persisted)
    give the one-call joint fit's posterior, and the reattached model keeps
    bordering touches."""
    rng = np.random.default_rng(41)
    n = 90
    x = rng.normal(size=(n, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.normal(size=(17, 3))
    kw = dict(normals=x, noise_g=np.full(n, 1e-3))
    models = []
    for pkg in (ooc, jooc):
        sd = str(tmp_path / pkg.__name__.split(".")[0])
        p = _params()[0 if pkg is ooc else 1]
        if pkg is ooc:
            ooc.ooc_factor_phase("rbf", _t(x), torch.zeros(n, dtype=torch.float64),
                                 torch.full((n,), 1e-4, dtype=torch.float64), p, panel=64,
                                 block=32, spill_dir=sd, normals=_t(kw["normals"]),
                                 noise_g=_t(kw["noise_g"]))
        else:
            jooc.ooc_factor_phase("rbf", _j(x), jnp.zeros(n), jnp.full(n, 1e-4), p, panel=64,
                                  block=32, spill_dir=sd, normals=_j(kw["normals"]),
                                  noise_g=_j(kw["noise_g"]))
        models.append(_solve(pkg, sd))
    m, jm = models
    assert isinstance(m, ooc.OOCJointModel) and m.alpha.shape[0] == 4 * m.n0
    ref = ooc.ooc_fit_joint("rbf", _t(x), torch.zeros(n, dtype=torch.float64), _t(x), 1e-4,
                            1e-3, _params()[0], panel=64, block=32, store="host")
    got = _predict(m, q)
    _close(got, _predict(jm, q))
    _close(got, _predict(ref, q))
    tx = np.array([[0.0, 0.0, 1.05]])
    m2 = m.update(_t(tx), torch.zeros(1, dtype=torch.float64), 1e-5)
    jm2 = jm.update(_j(tx), jnp.zeros(1), 1e-5)
    _close(_predict(m2, q), _predict(jm2, q))


# ------------------------------------------------------------------ codecs


def test_qpack_matches_jax_bit_for_bit():
    """tests/test_outofcore.py:1179: the int16 codes and float32 scales of
    both packages agree exactly, and the round trip stays within half an
    LSB of each (row, 512-column) block, ragged widths included."""
    rng = np.random.default_rng(7)
    for w in (1024, 777):
        a = rng.normal(size=(64, w)) * np.exp(rng.uniform(-3, 3, size=(64, 1)))
        q, s = ooc._qpack(_t(a))
        jq, js = jooc._qpack(_j(a))
        assert q.dtype == torch.int16 and q.shape[1] % 512 == 0
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        back = ooc._qunpack(q, s, w=w, dtype=torch.float64).numpy()
        np.testing.assert_array_equal(back, np.asarray(jooc._qunpack(jq, js, w=w,
                                                                     dtype=jnp.float64)))
        nb = q.shape[1] // 512
        bmax = np.abs(np.pad(a, ((0, 0), (0, nb * 512 - w))).reshape(64, nb, 512)).max(2)
        bound = np.repeat(0.501 * bmax / 32767.0, 512, axis=1)[:, :w]
        assert (np.abs(back - a) <= bound + 1e-12).all()


def test_int16_l_codec_fit_matches_jax(gpis_problem):
    """tests/test_outofcore.py:1220: every L panel through the codec
    (device_budget=0): the same quantized factor as JAX's, and the exact
    fit's posterior at the codec's grade."""
    x, y, noise, q = gpis_problem
    p, jp = _params(0.4, 1.0)
    kw = dict(panel=PANEL, block=BLOCK, device_budget=0)
    mq = ooc.ooc_fit("rbf", _t(x), _t(y), _t(noise), p, l_codec="int16", **kw)
    jmq = jooc.ooc_fit("rbf", _j(x), _j(y), _j(noise), jp, l_codec="int16", **kw)
    m64 = ooc.ooc_fit("rbf", _t(x), _t(y), _t(noise), p, **kw)
    got = _predict(mq, q)
    _close(got, _predict(jmq, q))
    _close(got, _predict(m64, q), atol=1e-3)


def test_phase_split_int16_codec_matches_jax(gpis_problem, tmp_path):
    """tests/test_outofcore.py:1240: coded L panels cross the phase boundary
    through the manifest's codec entries, which JAX's `open_dir` reads."""
    x, y, noise, q = gpis_problem
    p, jp = _params(0.4, 1.0)
    sd, jsd = str(tmp_path / "q16"), str(tmp_path / "q16_jax")
    ooc.ooc_factor_phase("rbf", _t(x), _t(y), _t(noise), p, panel=PANEL, block=BLOCK,
                         spill_dir=sd, device_budget=0, l_codec="int16")
    jooc.ooc_factor_phase("rbf", _j(x), _j(y), _j(noise), jp, panel=PANEL, block=BLOCK,
                          spill_dir=jsd, device_budget=0, l_codec="int16")
    with open(os.path.join(sd, "L", "manifest.json")) as f, \
            open(os.path.join(jsd, "L", "manifest.json")) as g:
        man, jman = json.load(f), json.load(g)
    assert man["panels"] == jman["panels"]
    assert all(e[2]["codec"] == "int16" for e in man["panels"].values())
    # The port's coded L, read by JAX's store, decodes to JAX's own panels.
    lst = jooc.TieredPanelStore.open_dir(jooc.DeviceBudget(0), os.path.join(sd, "L"))
    jlst = jooc.TieredPanelStore.open_dir(jooc.DeviceBudget(0), os.path.join(jsd, "L"))
    dev = jooc._compute_device()
    for j in (0, len(man["panels"]) - 1):
        np.testing.assert_allclose(np.asarray(jooc._fetch(lst, j, dev)),
                                   np.asarray(jooc._fetch(jlst, j, dev)), atol=1e-12)
    m, jm = _solve(ooc, sd, device_budget=0), _solve(jooc, jsd, device_budget=0)
    got = _predict(m, q)
    _close(got, _predict(jm, q))
    _close(got, _dense(x, y, noise, q, 0.4, 1.0), atol=1e-3)


# ------------------------------------------------- the TRSM-fused query


@pytest.mark.parametrize("keep_w", [True, False])
def test_fused_query_matches_the_post_hoc_query(keep_w, problem, tmp_path, monkeypatch):
    """tests/test_outofcore.py:1278 and :1305: the variance summed on the
    TRSM's W bands equals the post-hoc streamed query, and JAX's fused
    one; with keep_w=False the last sweep's panels are never written."""
    x, y, noise, q = problem
    budget = BUDGET if keep_w else 0
    rows0 = []
    quad_band = ooc._quad_band

    def spying(name, qq, cols, params, w_band, row0):
        rows0.append((row0, w_band.shape[0]))
        return quad_band(name, qq, cols, params, w_band, row0)

    monkeypatch.setattr(ooc, "_quad_band", spying)
    solve_kw = dict(device_budget=budget, fused_query=q, keep_w=keep_w, trsm_sweep=2)
    (m, pair), (jm, jpair) = _both_phases(tmp_path, problem, f"fused{keep_w}",
                                          {"device_budget": budget}, solve_kw)
    # Each sweep's W rows, at their global first row (Kernel F band's
    # row0, which the CPU twin cannot tell), one chunk of q each.
    assert rows0 == [(j0, 2 * PANEL) for j0 in range(0, C, 2 * PANEL)], rows0
    assert pair is not None and jpair is not None
    _close(pair, jpair)
    dense = _dense(x, y, noise, q)
    _close(pair, [dense[0], np.clip(dense[1], 0.0, None)])
    nb = C // PANEL
    monkeypatch.setattr(ooc, "_quad_band", quad_band)
    if keep_w:
        _close(pair, _predict(m, q), atol=1e-8)
        assert (nb - 1) in m.wstore
    else:
        assert (nb - 1) not in m.wstore and 0 in m.wstore


def test_deferred_alpha_matches_substitution(problem, tmp_path):
    """tests/test_outofcore.py:1329: alpha summed from the TRSM's W bands
    (defer_alpha) is the substitution alpha, and JAX's."""
    x, y, noise, q = problem
    sa, sb = str(tmp_path / "subst"), str(tmp_path / "defer")
    _factor(ooc, x, y, noise, sa, device_budget=0)
    _factor(ooc, x, y, noise, sb, device_budget=0, defer_alpha=True)
    with np.load(sa + "/state.npz") as da, np.load(sb + "/state.npz") as db:
        assert "alpha" in da.files and "alpha" not in db.files
    ma = _solve(ooc, sa, device_budget=0)
    mb, pair = _solve(ooc, sb, device_budget=0, fused_query=q, keep_w=True)
    np.testing.assert_allclose(mb.alpha.numpy(), ma.alpha.numpy(), atol=1e-9)
    _close(pair, _predict(ma, q), atol=1e-9)
    with np.load(sb + "/state.npz") as db:  # written back: L is consumed
        np.testing.assert_array_equal(db["alpha"], mb.alpha.numpy())


def test_deferred_alpha_resume_falls_back_to_substitution(problem, tmp_path):
    """tests/test_outofcore.py:1356: a resumed TRSM has lost the partial
    sum, so alpha is solved against the restored L panels."""
    x, y, noise, q = problem
    sd = str(tmp_path / "deferres")
    _factor(ooc, x, y, noise, sd, device_budget=0, defer_alpha=True)
    shutil.copytree(sd + "/L", sd + "/L_backup")
    assert _solve(ooc, sd, device_budget=0, stop_after=2) is None
    for f in os.listdir(sd + "/L_backup"):
        dst = os.path.join(sd, "L", f)
        if not os.path.exists(dst):
            os.link(os.path.join(sd, "L_backup", f), dst)
    m = _solve(ooc, sd, device_budget=0)
    _close(_predict(m, q), _dense(x, y, noise, q))


# ------------------------------------------------------------- float16 W


def test_f16_w_store_matches_jax(problem):
    """tests/test_outofcore.py:140: w_dtype=float16 narrows the spilled W
    panels only; the mean stays exact, the variance takes the rounding,
    the same rounding as JAX's."""
    x, y, noise, q = problem
    p, jp = _params()
    kw = dict(panel=PANEL, block=BLOCK, store="tiered", device_budget=BUDGET)
    m = ooc.ooc_fit("rbf", _t(x), _t(y), _t(noise), p, w_dtype=torch.float16, **kw)
    jm = jooc.ooc_fit("rbf", _j(x), _j(y), _j(noise), jp, w_dtype=jnp.float16, **kw)
    spilled = m.wstore.spilled()
    assert spilled and m.wstore.get(spilled[0]).dtype == torch.float16
    got, want = _predict(m, q), _predict(jm, q)
    np.testing.assert_allclose(got[0], want[0], atol=TOL)
    np.testing.assert_allclose(got[1], want[1], atol=F16_VAR_TOL)
    dense = _dense(x, y, noise, q)
    np.testing.assert_allclose(got[0], dense[0], atol=1e-6)
    np.testing.assert_allclose(got[1], dense[1], atol=5e-3)


def test_solve_phase_f16_device_w_matches_jax(problem, tmp_path):
    """tests/test_outofcore.py:1386: w_dtype=float16 in the solve phase
    narrows the resident W panels too; the fused and post-hoc queries keep
    the mean exact and match JAX's."""
    x, y, noise, q = problem
    sd, jsd = str(tmp_path / "f16w"), str(tmp_path / "f16w_jax")
    _factor(ooc, x, y, noise, sd, device_budget=BUDGET)
    _factor(jooc, x, y, noise, jsd, device_budget=BUDGET)
    m, pair = _solve(ooc, sd, w_dtype=torch.float16, device_budget=BUDGET, fused_query=q,
                     keep_w=True)
    jm, jpair = _solve(jooc, jsd, w_dtype=jnp.float16, device_budget=BUDGET, fused_query=q,
                       keep_w=True)
    for a, b in ((pair, jpair), (_predict(m, q), _predict(jm, q))):
        np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]), atol=TOL)
        np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]), atol=F16_VAR_TOL)
    dense = _dense(x, y, noise, q)
    np.testing.assert_allclose(pair[0], dense[0], atol=1e-6)
    np.testing.assert_allclose(pair[1], np.clip(dense[1], 0.0, None), atol=5e-2)
    assert m.wstore.get(0).dtype == torch.float16


def test_update_refuses_an_f16_spilled_w(problem):
    """tests/test_outofcore.py:733: bordering on a narrowed W is refused, in
    both packages, with the same guidance."""
    x, y, noise, _ = problem
    p, jp = _params()
    kw = dict(panel=PANEL, block=BLOCK, store="tiered", device_budget=BUDGET)
    m = ooc.ooc_fit("rbf", _t(x), _t(y), _t(noise), p, w_dtype=torch.float16, **kw)
    jm = jooc.ooc_fit("rbf", _j(x), _j(y), _j(noise), jp, w_dtype=jnp.float16, **kw)
    with pytest.raises(ValueError, match="w_dtype=None") as e:
        m.update(torch.tensor([[0.8, 0.0, 0.0]], dtype=torch.float64), 0.0, 1e-6)
    with pytest.raises(ValueError) as je:
        jm.update(jnp.zeros((1, 3)).at[0, 0].set(0.8), 0.0, 1e-6)
    assert str(e.value) == str(je.value)


# --------------------------------------------------------------- the guard


def test_residual_check_clean_and_corrupted_matches_jax(problem, tmp_path):
    """tests/test_outofcore.py:1418: the check passes on an intact fit and
    fails after an L panel on disk is damaged before the TRSM (alpha
    summed through it, defer_alpha); its numbers are JAX's on both."""
    x, y, noise, _ = problem
    results = {}
    for pkg in (ooc, jooc):
        name = pkg.__name__.split(".")[0]
        sd, sd2 = str(tmp_path / f"guard_{name}"), str(tmp_path / f"corrupt_{name}")
        _factor(pkg, x, y, noise, sd, device_budget=BUDGET)
        clean = pkg.ooc_residual_check(_solve(pkg, sd, device_budget=BUDGET))
        _factor(pkg, x, y, noise, sd2, device_budget=BUDGET, defer_alpha=True)
        mm = np.memmap(os.path.join(sd2, "L", "panel_1.bin"), dtype=np.float64, mode="r+")
        mm[:mm.size // 2] *= 1.003
        mm.flush()
        del mm
        results[name] = clean, pkg.ooc_residual_check(_solve(pkg, sd2, device_budget=BUDGET))
    (clean, bad), (jclean, jbad) = results["gpis_tpu_torch"], results["gpis_tpu"]
    assert clean["ok"] and clean["rel_bw"] < 1e-6, clean
    assert not bad["ok"] and bad["rel_y"] > 10 * clean["rel_y"], bad
    for got, want in ((clean, jclean), (bad, jbad)):
        assert got["ok"] == want["ok"] and got["rows"] == want["rows"]
        for k in ("residual", "rel_y"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-12)


def test_residual_check_joint_matches_jax(problem):
    """tests/test_outofcore.py:1457: the check samples the real value rows
    of the joint system and passes on an intact joint fit."""
    x, y, _, _ = problem
    n = 256
    p, jp = _params()
    m = ooc.ooc_fit_joint("rbf", _t(x[:n]), _t(y[:n]), _t(x[:n]), 1e-4, 1e-4, p, panel=256,
                          block=BLOCK)
    jm = jooc.ooc_fit_joint("rbf", _j(x[:n]), _j(y[:n]), _j(x[:n]), jnp.full((n,), 1e-4),
                            jnp.full((n,), 1e-4), jp, panel=256, block=BLOCK)
    res, jres = ooc.ooc_residual_check(m, block=128), jooc.ooc_residual_check(jm, block=128)
    assert res["ok"] and jres["ok"], (res, jres)
    assert res["rows"] == jres["rows"]
    # Both residuals are float64 rounding (~4e-11): held to its grade.
    assert max(res["residual"], jres["residual"]) < 1e-9, (res, jres)


# ------------------------------------------------------------- the planner


@pytest.mark.parametrize("c, panel, kw", [
    (102400, 4096, dict(limit=15_480_000_000, w_itemsize=2)),
    (100352, 2048, dict(limit=15_480_000_000, w_itemsize=2)),
    (1024, 256, dict(limit=15_480_000_000)),
    (2048, 256, dict(limit=0)),
    (32768, 4096, dict(limit=80_000_000_000, l_itemsize=2)),
])
def test_plan_sweeps_returns_jax_plan(c, panel, kw):
    """tests/test_outofcore.py:817's cases (and the H100's 80 GB with the
    int16 codec): the same dict as JAX's planner."""
    assert ooc.plan_sweeps(c, panel, 4, **kw) == jooc.plan_sweeps(c, panel, 4, **kw)


def test_plan_sweeps_refuses_a_ragged_capacity():
    for pkg in (ooc, jooc):
        with pytest.raises(ValueError):
            pkg.plan_sweeps(1000, 256, 4, limit=15_480_000_000)


# ------------------------------------------------- the split stream step


@pytest.mark.parametrize("trsm_sweep", [1, 3])
def test_split_stream_objective_matches_jax(trsm_sweep, tmp_path):
    """tests/test_ooc_hyperopt.py:216 and :248: ooc_factor_phase(
    defer_alpha=True) then ooc_mll_and_grad_solve_phase gives the one-call
    objective's (mll, grads), and JAX's split step's."""
    rng = np.random.default_rng(23)
    n = 500
    x = rng.normal(size=(n, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y, noise = rng.normal(size=n) * 0.2, rng.uniform(1e-4, 1e-2, size=n)
    p, jp = _params(0.7, 1.3)
    ref, g_ref = oho.ooc_mll_and_grad("rbf", _t(x), _t(y), _t(noise), p, panel=PANEL,
                                      block=BLOCK, store="host")
    sd, jsd = str(tmp_path / "step"), str(tmp_path / "step_jax")
    ooc.ooc_factor_phase("rbf", _t(x), _t(y), _t(noise), p, panel=PANEL, block=BLOCK,
                         spill_dir=sd, defer_alpha=True, device_budget=1 << 62)
    mll, g = oho.ooc_mll_and_grad_solve_phase(sd, noise_base=_t(noise), trsm_sweep=trsm_sweep,
                                              device_budget=1 << 62, device="cpu")
    jooc.ooc_factor_phase("rbf", _j(x), _j(y), _j(noise), jp, panel=PANEL, block=BLOCK,
                          spill_dir=jsd, defer_alpha=True, device_budget=1 << 62)
    jmll, jg = joho.ooc_mll_and_grad_solve_phase(jsd, noise_base=_j(noise),
                                                 trsm_sweep=trsm_sweep, device_budget=1 << 62)
    for want, want_g in ((ref, g_ref), (jmll, jg)):
        np.testing.assert_allclose(float(mll), float(want), rtol=1e-9)
        for k in want_g:
            np.testing.assert_allclose(float(g[k]), float(want_g[k]), rtol=1e-7, err_msg=k)
    assert not os.listdir(os.path.join(sd, "L"))  # the stores are cleared


# -------------------------------------------------------- the store itself


def test_write_through_store_clear_removes_files_and_manifest(tmp_path):
    """tests/test_outofcore.py:596: a resident panel is mirrored to disk as
    it is stored; clear() takes the files and the manifest."""
    st = ooc.TieredPanelStore(ooc.DeviceBudget(1 << 30), "cpu", spill_dir=str(tmp_path / "S"),
                              write_through=True)
    st.put(0, torch.ones((4, 4), dtype=torch.float32))
    assert 0 not in st.spilled() and os.path.exists(tmp_path / "S" / "panel_0.bin")
    st.save_manifest()
    back = jooc.TieredPanelStore.open_dir(jooc.DeviceBudget(0), str(tmp_path / "S"))
    np.testing.assert_array_equal(np.asarray(back.get(0).read()), np.ones((4, 4)))
    st.clear()
    assert not os.listdir(tmp_path / "S")


def test_evict_all_keeps_the_compute_dtype(tmp_path):
    """tests/test_outofcore.py:629: evicting a float16-resident store keeps
    its compute dtype, so a fetch widens the panel back."""
    st = ooc.TieredPanelStore(ooc.DeviceBudget(1 << 30), "cpu", device_dtype=torch.float16,
                              spill_dir=str(tmp_path / "E"))
    a = torch.as_tensor(np.random.default_rng(0).normal(size=(8, 8)), dtype=torch.float32)
    st.put(0, a)
    assert st.compute_dtype == torch.float32 and st.has_compressed_panels()
    st.evict_all()
    assert st.compute_dtype == torch.float32 and st.spilled() == [0]
    got = ooc._fetch(st, 0)[0]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), a.to(torch.float16).float().numpy())
