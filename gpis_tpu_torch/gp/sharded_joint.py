"""Sharded GP with derivative (normal) observations, config 2 at config 5's
scale (port of gpis_tpu/gp/sharded_joint.py).

The joint system (dimension-major, `kernels.cuda_joint.joint_meta`) is
row-band-sharded like the value system and runs the same distributed
pipeline (`linalg.sharded`: Cholesky, W = L^{-1}, alpha, ring query); only
the band assembly and the query's columns differ.  Joint index space,
J = 4C + T:

    [ f(1..C) | d1(1..C) | d2(1..C) | d3(1..C) | f(touch 1..T) ]

The T trailing rows are value-only tactile slots, preallocated inert
(origin point, pad noise) inside the last rank's band and filled by
`ShardedJointModel.update` through the tail-band bordering: never a whole
refactor.

The kernels: each rank's band of joint rows is Kernel E in band mode
(`cuda_joint.joint_rows(..., row0=rank J / P)`, its noise on the global
diagonal); the factor's panel updates Kernel G and W's trailing update
Kernel L (`linalg.sharded`); the query's mean Kernel E against the joint
columns and each ring hop's quad Kernel F's band mode over the packed joint
columns (`joint_cross`, `joint_band`).  On the CPU each takes its plain twin
(`joint_rows_reference` for the band: the JAX package's jnp fallback
`_joint_band_rows`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from gpis_tpu_torch.gp.model import as_dtype, round_up
from gpis_tpu_torch.gp.sharded_model import _all_gather
from gpis_tpu_torch.kernels import cuda_joint
from gpis_tpu_torch.kernels import derivative as kd
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.linalg import cholesky as lin
from gpis_tpu_torch.linalg import sharded as sh
from gpis_tpu_torch.parallel.mesh import RowMesh, make_row_mesh

__all__ = ["ShardedJointModel", "fit_sharded_joint", "sharded_joint_gram"]


def _joint_meta(x_all: torch.Tensor, c: int):
    """(coords, dirs, flag) of the joint index space of x_all (C + T, 3)."""
    return cuda_joint.joint_meta(x_all[:c], x_all[c:] if x_all.shape[0] > c else None)


def _joint_noise(nf_all: torch.Tensor, ng: torch.Tensor, c: int) -> torch.Tensor:
    """The (J,) observation noise [nf core | ng x 3 | nf touch]."""
    t = nf_all.shape[0] - c
    return cuda_joint.joint_noise(c, nf_all[:c], ng, nf_all[c:] if t else None, nf_all)


def _joint_band_rows(name: str, x_all, params, nf_all, ng, row0: int, rows: int, c: int,
                     noise: bool = True) -> torch.Tensor:
    """Joint covariance rows [row0, row0 + rows) (rows, J), with each row's
    observation noise on the global diagonal unless `noise` is False:
    Kernel E in band mode on a card, its twin on the CPU."""
    meta = _joint_meta(x_all, c)
    band = tuple(m[row0:row0 + rows] for m in meta)
    noise_col = _joint_noise(nf_all, ng, c) if noise else None
    return cuda_joint.joint_rows(name, band, meta, params, noise_col=noise_col, row0=row0)


def sharded_joint_gram(name: str, x_all, params, nf_all, ng, mesh: RowMesh, *,
                       c: int | None = None) -> torch.Tensor:
    """This rank's (J / P, J) band of the joint Gram, J = 4C + T, from the
    replicated x_all (C + T, 3), nf_all (C + T,) and ng (C,); `c` defaults
    to x_all.shape[0] (T = 0).  No communication."""
    if not kf.supports_derivatives(name):
        raise ValueError(f"kernel {name!r} does not support derivative observations")
    c = x_all.shape[0] if c is None else c
    j_tot = 3 * c + x_all.shape[0]
    if j_tot % mesh.size:
        raise ValueError(f"joint size {j_tot} not divisible by mesh size {mesh.size}")
    dt, dev = x_all.dtype, x_all.device
    nf_all = torch.as_tensor(nf_all, dtype=dt, device=dev).broadcast_to((x_all.shape[0],))
    ng = torch.as_tensor(ng, dtype=dt, device=dev).broadcast_to((c,))
    row0, rows = mesh.band(j_tot)
    return _joint_band_rows(name, x_all, params, nf_all, ng, row0, rows, c)


def _joint_update_tail(name: str, params, x_all, nf_all, ng, c: int, l_loc: torch.Tensor,
                       w_loc: torch.Tensor, mesh: RowMesh):
    """Re-form the LAST row band of the sharded joint factor and of W after
    its touch rows changed (the joint mirror of `sh.sharded_update_tail`,
    whose docstring has the bordering algebra).  The touch rows live at the
    joint tail, inside the last rank's band (`fit_sharded_joint` holds
    T <= J / P).  Returns this rank's (l_loc, w_loc)."""
    j_tot = l_loc.shape[1]
    band = j_tot // mesh.size
    rest = j_tot - band
    dt, dev = l_loc.dtype, l_loc.device
    last = mesh.rank == mesh.size - 1
    if last:  # its columns of L21 are zero: W11 has none of its rows
        l21_cols = torch.zeros((band, band), dtype=dt, device=dev)
        part = torch.zeros((band, j_tot), dtype=dt, device=dev)
    else:
        # The noise diagonal lands in columns [rest, J), which meet zero
        # entries of the leading W rows: no noise is needed here.
        kt = _joint_band_rows(name, x_all, params, nf_all, ng, rest, band, c, noise=False)
        l21_cols = kt @ w_loc.T
        del kt
        part = l21_cols @ w_loc
    parts = sh._all_gather(l21_cols, mesh.size)
    t = sh._psum(part)  # L21 W, (band, J)
    if not last:
        return l_loc, w_loc
    l21 = torch.cat(parts, dim=1)  # (band, J)
    meta = _joint_meta(x_all, c)
    tail = tuple(m[rest:] for m in meta)
    k22 = cuda_joint.joint_rows(name, tail, tail, params,
                                noise_col=_joint_noise(nf_all, ng, c)[rest:].contiguous())
    l22 = lin.cholesky(k22 - l21 @ l21.T)
    # Row-major, as the query's band kernel reads W.
    w_tail = (-torch.linalg.solve_triangular(l22, t, upper=False)).contiguous()
    w_tail[:, rest:] = torch.linalg.solve_triangular(
        l22, torch.eye(band, dtype=dt, device=dev), upper=False)
    l21[:, rest:] = l22
    return l21, w_tail


def _joint_capacity(n: int, touch: int, p: int, block: int) -> tuple[int, int]:
    """Smallest (C, T), C >= n core slots and T >= touch tail slots, with
    J = 4C + T a multiple of p x block (each band whole factor blocks) and
    the touch band inside the last rank's band (T <= J / p)."""
    c = round_up(n, p)
    for _ in range(8 * block + 8):
        rem = (-(4 * c)) % (p * block)
        if touch == 0:
            if rem == 0:
                return c, 0
        else:
            t = rem
            if t < touch:
                t += round_up(touch - t, p * block)
            elif t == 0:
                t = round_up(touch, p * block)
            if t <= (4 * c + t) // p:
                return c, t
        c += p
    raise ValueError(f"no joint capacity found for n={n}, touch={touch}, p={p}, block={block}")


def joint_cross(name, q, x, params, c: int):
    """The joint cross-covariance of value queries q against the columns
    [4C core | T touch] of x for core capacity C (Kernel E)."""
    return cuda_joint.joint_rows(name, cuda_joint.value_meta(q), _joint_meta(x, c), params)


def joint_band(x, c: int):
    """Kernel F band mode's generator and packed columns for the same
    layout, the ring quad's side of `joint_cross`."""
    return "joint", cuda_joint.pack_meta(_joint_meta(x, c))


@dataclasses.dataclass
class ShardedJointModel:
    """This rank's part of a sharded joint (value + gradient) GP: l and w are
    its (J / P, J) row bands; the rest is replicated.  `params` holds
    Python floats."""

    kernel: str
    x: torch.Tensor  # (C + T, 3): core points, then touch slots
    params: dict
    l: torch.Tensor  # (J / P, J) band of the factor, J = 4C + T
    w: torch.Tensor  # (J / P, J) band of L^{-1}
    alpha: torch.Tensor  # (J,)
    mesh: RowMesh
    block: int
    n0: int  # core capacity C
    normals: torch.Tensor | None = None  # (C, 3)
    y: torch.Tensor | None = None  # (J,) joint targets [f | d1 | d2 | d3 | touch]
    noise_f: torch.Tensor | None = None  # (C + T,) value-observation noise
    noise_g: torch.Tensor | None = None  # (C,) gradient-observation noise
    n_touch: int = 0
    n_real: int = 0  # real (non-padding) core points
    pad_noise: float = 1e10

    @property
    def capacity(self) -> int:
        return self.n0

    @property
    def touch_capacity(self) -> int:
        return self.x.shape[0] - self.n0

    @property
    def noise(self) -> torch.Tensor:
        """Value-observation noise over the core rows (the planner's
        on-surface test reads model.y and model.noise)."""
        return self.noise_f[:self.n0]

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def device(self) -> torch.device:
        return self.x.device

    def predict(self, q: torch.Tensor, *, precision=None):
        """Posterior (mean, variance) of f at q (M, 3), the same on every
        rank (q padded to a multiple of P, each rank's shard joined by an
        all-gather)."""
        m, p = q.shape[0], self.mesh.size
        pad = (-m) % p
        q = q.to(self.dtype)
        qp = torch.cat([q, q.new_zeros((pad, 3))]) if pad else q
        mean, var = sh.sharded_predict_linv(self.kernel, qp.contiguous(), self.x, self.params,
                                            self.alpha, self.w, self.mesh, precision=precision,
                                            cross_fn=functools.partial(joint_cross, c=self.n0),
                                            band=joint_band(self.x, self.n0))
        return _all_gather(mean, p)[:m], _all_gather(var, p)[:m]

    def update(self, new_x, new_y, new_noise) -> "ShardedJointModel":
        """Write tactile points into the tail slots and re-form the last row
        band by the joint bordering update (every rank passes the same
        points).  The noise is floored at 4 eps J k(0).  Returns a new
        model."""
        c, t_cap = self.n0, self.touch_capacity
        dt, dev = self.dtype, self.device
        new_x = torch.as_tensor(new_x).to(dtype=dt, device=dev)
        k_new = new_x.shape[0]
        if self.n_touch + k_new > t_cap:
            raise ValueError(
                f"cumulative touches {self.n_touch + k_new} exceed touch "
                f"capacity {t_cap}; refit with a larger touch_capacity"
            )
        slot, jrow = c + self.n_touch, 4 * c + self.n_touch
        x, y, noise_f = self.x.clone(), self.y.clone(), self.noise_f.clone()
        x[slot:slot + k_new] = new_x
        y[jrow:jrow + k_new] = torch.as_tensor(new_y, dtype=dt, device=dev).broadcast_to((k_new,))
        floor = 4.0 * torch.finfo(dt).eps * (4 * c + t_cap) * abs(
            float(kf.k_diag0(self.kernel, self.params)))
        noise_f[slot:slot + k_new] = torch.clamp(
            torch.as_tensor(new_noise, dtype=dt, device=dev).broadcast_to((k_new,)), min=floor)
        l_new, w_new = _joint_update_tail(self.kernel, self.params, x, noise_f, self.noise_g, c,
                                          self.l, self.w, self.mesh)
        alpha = sh.sharded_alpha_from_linv(w_new, y, self.mesh)
        return dataclasses.replace(self, x=x, y=y, noise_f=noise_f, l=l_new, w=w_new,
                                   alpha=alpha, n_touch=self.n_touch + k_new)


def fit_sharded_joint(kernel: str, x, y, normals, noise_f, noise_g, params,
                      mesh: RowMesh | None = None, *, n_devices: int | None = None,
                      block: int = 128, touch_capacity: int = 0, pad_noise: float = 1e10,
                      dtype=None) -> ShardedJointModel:
    """Distributed joint fit on `mesh` (or a row mesh of n_devices ranks on
    the device of x, when x is a tensor, else on CUDA), in `dtype` (x's when
    None).  Every rank passes the same x (N, 3), y (N,), normals (N, 3) and
    noises (scalars or (N,)).  The core capacity C is padded so that
    J = 4C + T tiles the mesh, with T touch slots at the joint tail inside
    the last rank's band.  The ladder tries no jitter, then 1, 100 and 1e4 x
    4 eps J k(0) on the diagonal while the factor's diagonal has a NaN on
    any rank, and folds the jitter that held into the stored noises.  On a
    card: Kernel E's band mode, Kernel G's panel updates, Kernel L's TRSM."""
    mesh = mesh or make_row_mesh(n_devices, x.device if torch.is_tensor(x) else "cuda")
    x = torch.as_tensor(x, device=mesh.device)
    dt, dev, p = as_dtype(dtype, x), mesh.device, mesh.size
    n = x.shape[0]
    c, t_slots = _joint_capacity(n, touch_capacity, p, block)
    j_tot = 4 * c + t_slots

    def padded(v, fill, shape):
        out = torch.full(shape, fill, dtype=dt, device=dev)
        out[:n] = torch.as_tensor(v, dtype=dt, device=dev).broadcast_to((n,) + shape[1:])
        return out

    xp = padded(x, 0.0, (c + t_slots, 3))
    yp = padded(y, 0.0, (c,))
    nrm = padded(normals, 0.0, (c, 3))
    nf = padded(noise_f, pad_noise, (c + t_slots,))
    ng = padded(noise_g, pad_noise, (c,))
    params = {k: float(v) for k, v in params.items()}
    jitter = 4.0 * torch.finfo(dt).eps * j_tot * abs(float(kf.k_diag0(kernel, params)))
    cuda = dev.type == "cuda"
    for extra in (0.0, jitter, jitter * 100.0, jitter * 1e4):
        a = sharded_joint_gram(kernel, xp, params, nf + extra, ng + extra, mesh, c=c)
        l = sh.sharded_cholesky(a, mesh, block=block)
        if not sh.any_nan_diagonal(l, mesh):
            nf, ng = nf + extra, ng + extra
            break
        del a, l
    else:
        raise FloatingPointError("sharded joint Cholesky failed even with jitter")
    w = sh.sharded_linv(l, mesh, block=block, use_kernel=cuda)
    yj = kd.joint_targets(yp, nrm)
    if t_slots:
        yj = torch.cat([yj, torch.zeros((t_slots,), dtype=dt, device=dev)])
    alpha = sh.sharded_alpha_from_linv(w, yj, mesh)
    return ShardedJointModel(kernel=kernel, x=xp, params=params, l=l, w=w, alpha=alpha,
                             mesh=mesh, block=block, n0=c, normals=nrm, y=yj, noise_f=nf,
                             noise_g=ng, n_real=n, pad_noise=pad_noise)
