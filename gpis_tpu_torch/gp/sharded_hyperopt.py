"""Distributed hyperparameter optimization on the row mesh (port of
gpis_tpu/gp/sharded_hyperopt.py:53-270).

No autograd crosses a collective.  One objective evaluation is one sharded
fit at theta (`linalg.sharded`: band Gram -> distributed Cholesky -> W ->
alpha, Kernels A band and G on a card) and one gradient pass that uses the
exact identity

    d MLL / d theta = 1/2 (alpha^T dK alpha - tr(K^{-1} dK)),  K^{-1} = W^T W,

with every term split over the row bands:

* the lengthscale: dK's band by `torch.func.jvp` of this rank's band
  assembly; alpha^T dK alpha as band partials and an all-reduce; the trace
  sum(W dK . W) over a ring: this rank's W band stays, each rank's dK band
  visits every rank once (the JAX package's `ppermute`, here
  `dist.batch_isend_irecv` to the next rank: NCCL on the card, gloo in the
  tests);
* the noise scale: tr = diag(K^{-1}).dn, diag(K^{-1}) the all-reduced
  column norms of the W bands;
* the signal variance, free: dK/d(log sv) = K - D (every built-in kernel is
  linear in sv).

The JOINT system (value + gradient, `gp.sharded_joint`) takes the same
identities: `sharded_joint_mll_and_grad` swaps the band jvp target for the
joint twin and the noise directions for the joint layout [f(C) | d1..d3(C)
| touch(T)]; the ring trace and diag(K^{-1}) carry over.

`_mll_ascent` is the Adam ascent shared with `gp.ooc_hyperopt`.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from gpis_tpu_torch.gp.sharded_joint import _joint_meta, sharded_joint_gram
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.kernels import gram as kg
from gpis_tpu_torch.kernels.cuda_joint import joint_rows_reference
from gpis_tpu_torch.linalg import sharded as sh
from gpis_tpu_torch.parallel.mesh import RowMesh

__all__ = ["sharded_mll_and_grad", "optimize_sharded", "sharded_joint_mll_and_grad",
           "optimize_sharded_joint"]


def _ring_trace(dk_loc: torch.Tensor, w_loc: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """tr(K^{-1} dK) = sum(W dK . W) over the ring: my W band stays, each
    rank's dK band visits every rank once; at hop s the visiting band is
    rank (me - s) mod P's, which meets my W band's columns of its rows."""
    p, me = mesh.size, mesh.rank
    band = dk_loc.shape[0]
    acc = torch.zeros_like(w_loc)
    visiting = dk_loc.contiguous()
    for s in range(p):
        q = (me - s) % p
        acc += w_loc[:, q * band:(q + 1) * band] @ visiting
        if p > 1 and s < p - 1:
            got = torch.empty_like(visiting)
            ops = [dist.P2POp(dist.isend, visiting, (me + 1) % p),
                   dist.P2POp(dist.irecv, got, (me - 1) % p)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            visiting = got
    return sh._psum(torch.sum(acc * w_loc).reshape(1))[0]


def _mll_and_grad_collective(kernel, x, y, noise, mask, alpha, l_loc, w_loc, mesh: RowMesh, *,
                             lengthscale, signal_variance, noise_scale):
    """One gradient pass: (mll_core, g_log_ls, g_log_noise_scale, g_log_sv)
    with mll_core = -y.alpha/2 - log|L|, without the -C/2 log(2 pi) and the
    padding correction (the caller adds them).  Replicated: x, y, noise,
    mask (1 on real rows), alpha; this rank's bands: l_loc, w_loc."""
    c = x.shape[0]
    row0, band = mesh.band(c)
    dt, dev = x.dtype, x.device
    sv = torch.as_tensor(signal_variance, dtype=dt, device=dev)
    log_ls = torch.log(torch.as_tensor(lengthscale, dtype=dt, device=dev))
    scale = torch.as_tensor(noise_scale, dtype=dt, device=dev)
    alpha_loc = alpha[row0:row0 + band]

    logdet = sh._psum(torch.sum(torch.log(l_loc[:, row0:row0 + band].diagonal())).reshape(1))[0]

    def band_k(lls):
        return kg._gram_band_rows(kernel, x[row0:row0 + band], x, {
            "lengthscale": torch.exp(lls), "signal_variance": sv}, None, row0)

    _, dk_loc = torch.func.jvp(band_k, (log_ls,), (torch.ones_like(log_ls),))
    quad_ls = sh._psum((alpha_loc @ (dk_loc @ alpha)).reshape(1))[0]
    tr_ls = _ring_trace(dk_loc, w_loc, mesh)

    diag_kinv = sh._psum(torch.sum(w_loc * w_loc, dim=0))
    dn = mask * noise * scale
    a2 = alpha * alpha
    ya = y @ alpha
    n_eff = torch.where(mask > 0, noise * scale, noise)
    mll_core = -0.5 * ya - logdet
    g_logls = 0.5 * (quad_ls - tr_ls)
    g_lognoise = 0.5 * (a2 @ dn - diag_kinv @ dn)
    g_logsv = 0.5 * ((ya - a2 @ n_eff) - (c - diag_kinv @ n_eff))
    return mll_core, g_logls, g_lognoise, g_logsv


def sharded_mll_and_grad(kernel, xp, yp, noisep, params, mesh: RowMesh, *, block: int = 256,
                         n_real: int | None = None, noise_scale=1.0):
    """MLL value and exact gradients w.r.t. (log lengthscale, log noise
    scale, log signal variance) on padded, row-shardable replicated arrays:
    one sharded fit at theta (Kernel G's panel updates on a card), then one
    gradient pass.  Every rank calls it with the same arguments.  Returns
    (mll, {"log_ls", "log_noise_scale", "log_sv"}), 0-d tensors."""
    c = xp.shape[0]
    dt, dev = xp.dtype, xp.device
    real = (torch.arange(c, device=dev) < (n_real if n_real is not None else c)).to(dt)
    scale = torch.as_tensor(noise_scale, dtype=dt, device=dev)
    noise_eff = torch.where(real > 0, noisep * scale, noisep)
    params = {k: float(v) for k, v in params.items()}

    a = sh.sharded_gram(kernel, xp, params, noise_eff, mesh)
    l_loc = sh.sharded_cholesky(a, mesh, block=block)
    w_loc = sh.sharded_linv(l_loc, mesh, block=block)
    alpha = sh.sharded_alpha_from_linv(w_loc, yp, mesh)
    mll_core, g_ls, g_ns, g_sv = _mll_and_grad_collective(
        kernel, xp, yp, noisep, real, alpha, l_loc, w_loc, mesh,
        lengthscale=params["lengthscale"], signal_variance=params["signal_variance"],
        noise_scale=scale)
    mll = mll_core - 0.5 * c * math.log(2.0 * math.pi)
    if n_real is not None:
        mll = mll + torch.sum(0.5 * torch.log(2.0 * math.pi * noise_eff[n_real:]))
    return mll, {"log_ls": g_ls, "log_noise_scale": g_ns, "log_sv": g_sv}


def _mll_ascent(eval_fn, kernel, init_params, dt, *, steps, learning_rate, learn_noise,
                learn_signal):
    """Adam ascent over <= 3 host scalars (log lengthscale, [log noise
    scale], [log signal variance]); `eval_fn(params, scale) -> (mll,
    grads)` is one fit and one gradient pass.  Each MLL is paired with the
    theta it was evaluated at; the best is returned.  learn_signal rests on
    dK/d(log sv) = K - D, exact for kernels linear in the signal variance
    (the built-ins): a registered kernel is refused."""
    if learn_signal and kernel not in kf.KERNEL_NAMES:
        raise ValueError(
            f"learn_signal requires a kernel linear in signal_variance; "
            f"custom kernel {kernel!r} is not certified for the "
            f"dK/d(log sv) = K - D identity"
        )
    keys = ["log_ls"] + (["log_noise_scale"] if learn_noise else []) + (
        ["log_sv"] if learn_signal else [])
    sv0 = float(init_params["signal_variance"])
    theta0 = {"log_ls": math.log(float(init_params["lengthscale"])), "log_noise_scale": 0.0,
              "log_sv": math.log(sv0)}
    theta = torch.tensor([theta0[k] for k in keys], dtype=dt).requires_grad_(True)
    opt = torch.optim.Adam([theta], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    best_theta, best_val, history = theta.detach().clone(), -math.inf, []

    def unpack(t):
        th = dict(zip(keys, t.tolist()))
        params = {"lengthscale": math.exp(th["log_ls"]),
                  "signal_variance": math.exp(th["log_sv"]) if learn_signal else sv0}
        return params, math.exp(th.get("log_noise_scale", 0.0))

    for _ in range(steps):
        prm, scale = unpack(theta.detach())
        mll, g = eval_fn(prm, scale)
        v = float(mll)
        history.append(v)
        if v > best_val:
            best_theta, best_val = theta.detach().clone(), v
        theta.grad = torch.tensor([-float(g[k]) for k in keys], dtype=dt)
        opt.step()
    params, scale = unpack(best_theta)
    return {"params": params, "noise_scale": scale, "mll": best_val, "history": history}


def optimize_sharded(kernel, xp, yp, noisep, init_params, mesh: RowMesh, *, block: int = 256,
                     n_real: int | None = None, steps: int = 25, learning_rate: float = 0.1,
                     learn_noise: bool = True, learn_signal: bool = False):
    """Distributed MLL ascent, config 3 at config 5's scale: one sharded fit
    and one gradient pass a step.  Every rank calls it with the same
    arguments and gets the same answer.  Returns a dict: params (the best,
    Python floats), noise_scale, mll, history."""
    def eval_fn(prm, scale):
        return sharded_mll_and_grad(kernel, xp, yp, noisep, prm, mesh, block=block,
                                    n_real=n_real, noise_scale=scale)

    return _mll_ascent(eval_fn, kernel, init_params, xp.dtype, steps=steps,
                       learning_rate=learning_rate, learn_noise=learn_noise,
                       learn_signal=learn_signal)


# ------------------------------------------------------ joint (config 2)

# Columns of the joint dK band formed at once: its jvp holds (band, this, 3)
# temporaries, not (band, J, 3).
_JOINT_COL_CHUNK = 4096


def _joint_dk_band(kernel, x_all, c: int, row0: int, rows: int, log_ls, sv) -> torch.Tensor:
    """Rows [row0, row0 + rows) of dK / d(log ls) of the joint system: the
    jvp of the blended joint twin (`joint_rows_reference`, whose gradient-
    block diagonals do depend on the lengthscale), by column chunks; the
    observation noise is theta-independent and left out."""
    meta = _joint_meta(x_all, c)
    rmeta = tuple(m[row0:row0 + rows] for m in meta)
    j_tot = meta[0].shape[0]
    out = torch.empty((rows, j_tot), dtype=x_all.dtype, device=x_all.device)
    for s0 in range(0, j_tot, _JOINT_COL_CHUNK):
        cmeta = tuple(m[s0:s0 + _JOINT_COL_CHUNK] for m in meta)

        def band(lls, cmeta=cmeta):
            return joint_rows_reference(kernel, rmeta, cmeta, {
                "lengthscale": torch.exp(lls), "signal_variance": sv})

        out[:, s0:s0 + _JOINT_COL_CHUNK] = torch.func.jvp(band, (log_ls,),
                                                          (torch.ones_like(log_ls),))[1]
    return out


def _joint_collective(kernel, x_all, yj, dn, n_eff, alpha, l_loc, w_loc, mesh: RowMesh, *,
                      c: int, lengthscale, signal_variance):
    """The gradient pass of the JOINT system (J = 4C + T): the value pass's
    identities with the band jvp of the joint twin (`_joint_dk_band`) and
    the joint-layout noise directions: dn = d(noise diagonal) / d(log
    value-noise scale), n_eff the effective noise diagonal.  Returns
    (mll_core, g_log_ls, g_log_noise_scale, g_log_sv)."""
    j_tot = 3 * c + x_all.shape[0]
    row0, band = mesh.band(j_tot)
    dt, dev = x_all.dtype, x_all.device
    sv = torch.as_tensor(signal_variance, dtype=dt, device=dev)
    log_ls = torch.log(torch.as_tensor(lengthscale, dtype=dt, device=dev))
    alpha_loc = alpha[row0:row0 + band]

    logdet = sh._psum(torch.sum(torch.log(l_loc[:, row0:row0 + band].diagonal())).reshape(1))[0]
    dk_loc = _joint_dk_band(kernel, x_all, c, row0, band, log_ls, sv)
    quad_ls = sh._psum((alpha_loc @ (dk_loc @ alpha)).reshape(1))[0]
    tr_ls = _ring_trace(dk_loc, w_loc, mesh)
    del dk_loc

    diag_kinv = sh._psum(torch.sum(w_loc * w_loc, dim=0))
    a2 = alpha * alpha
    ya = yj @ alpha
    mll_core = -0.5 * ya - logdet
    g_logls = 0.5 * (quad_ls - tr_ls)
    g_lognoise = 0.5 * (a2 @ dn - diag_kinv @ dn)
    g_logsv = 0.5 * ((ya - a2 @ n_eff) - (j_tot - diag_kinv @ n_eff))
    return mll_core, g_logls, g_lognoise, g_logsv


def _joint_noise_vectors(nf_all, ng, c: int, n_real: int, n_touch: int, scale, dt):
    """(dn, n_eff, real_mask) over the joint layout [f(C) | d1 d2 d3 (C) |
    touch(T)].  The value-noise scale multiplies the REAL core value rows
    only (the gradient-noise family stays fixed, and the touches keep their
    own noise)."""
    ct = nf_all.shape[0]
    t = ct - c
    dev = nf_all.device
    core_real = (torch.arange(c, device=dev) < n_real).to(dt)
    nf_core = nf_all[:c]
    parts_dn = [core_real * nf_core * scale, torch.zeros((3 * c,), dtype=dt, device=dev)]
    parts_ne = [torch.where(core_real > 0, nf_core * scale, nf_core), ng, ng, ng]
    parts_real = [core_real] * 4
    if t:
        parts_dn.append(torch.zeros((t,), dtype=dt, device=dev))
        parts_ne.append(nf_all[c:])
        parts_real.append((torch.arange(t, device=dev) < n_touch).to(dt))
    return torch.cat(parts_dn), torch.cat(parts_ne), torch.cat(parts_real)


def sharded_joint_mll_and_grad(kernel, x_all, yj, nf_all, ng, params, mesh: RowMesh, *, c: int,
                               block: int = 128, n_real: int | None = None, n_touch: int = 0,
                               noise_scale=1.0):
    """Joint-system MLL and exact gradients w.r.t. (log lengthscale, log
    value-noise scale, log signal variance) over the mesh: one sharded joint
    fit at theta (Kernels E band, G and L on a card), then one gradient
    pass.  x_all (C + T, 3), yj (J,), nf_all (C + T,) and ng (C,) are the
    `ShardedJointModel` fields; every rank passes the same.  Returns (mll,
    {"log_ls", "log_noise_scale", "log_sv"}), 0-d tensors."""
    dt, dev = x_all.dtype, x_all.device
    j_tot = 3 * c + x_all.shape[0]
    scale = torch.as_tensor(noise_scale, dtype=dt, device=dev)
    nr = n_real if n_real is not None else c
    dn, n_eff, real_j = _joint_noise_vectors(nf_all, ng, c, nr, n_touch, scale, dt)
    nf_eff = torch.cat([n_eff[:c], nf_all[c:]])
    params = {k: float(v) for k, v in params.items()}

    cuda = dev.type == "cuda"
    a = sharded_joint_gram(kernel, x_all, params, nf_eff, ng, mesh, c=c)
    l_loc = sh.sharded_cholesky(a, mesh, block=block)
    w_loc = sh.sharded_linv(l_loc, mesh, block=block, use_kernel=cuda)
    alpha = sh.sharded_alpha_from_linv(w_loc, yj, mesh)
    mll_core, g_ls, g_ns, g_sv = _joint_collective(
        kernel, x_all, yj, dn, n_eff, alpha, l_loc, w_loc, mesh, c=c,
        lengthscale=params["lengthscale"], signal_variance=params["signal_variance"])
    # The inert rows (padded core rows, empty touch slots) each add a
    # theta-independent -1/2 log(2 pi n): taken back out.
    mll = (mll_core - 0.5 * j_tot * math.log(2.0 * math.pi)
           + torch.sum(torch.where(real_j > 0, 0.0, 0.5 * torch.log(2.0 * math.pi * n_eff))))
    return mll, {"log_ls": g_ls, "log_noise_scale": g_ns, "log_sv": g_sv}


def optimize_sharded_joint(kernel, x_all, yj, nf_all, ng, init_params, mesh: RowMesh, *, c: int,
                           block: int = 128, n_real: int | None = None, n_touch: int = 0,
                           steps: int = 25, learning_rate: float = 0.1,
                           learn_noise: bool = True, learn_signal: bool = False):
    """Distributed joint MLL ascent (config 3 on config 2 at config 5's
    scale): exact gradients, one sharded joint fit and one gradient pass a
    step.  The value-noise scale multiplies the real core rows; the
    gradient-noise family stays fixed.  Returns a dict: params (the best,
    Python floats), noise_scale, mll, history."""
    def eval_fn(prm, scale):
        return sharded_joint_mll_and_grad(kernel, x_all, yj, nf_all, ng, prm, mesh, c=c,
                                          block=block, n_real=n_real, n_touch=n_touch,
                                          noise_scale=scale)

    return _mll_ascent(eval_fn, kernel, init_params, x_all.dtype, steps=steps,
                       learning_rate=learning_rate, learn_noise=learn_noise,
                       learn_signal=learn_signal)
