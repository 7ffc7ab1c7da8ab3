"""Plain reference of the GPIS model: the training set, the covariances, the
posterior and the marginal likelihood, in plain PyTorch.

Written from the model's definition, not from the program: it imports
nothing of the package under test and takes nothing the program made.  It
is handed the same world-frame cloud, normals and contacts the benchmark
handed to the program, and works out the frame, the labels, the noises and
the factor itself.  Runs are in float64; the control runs the same code in
float32 with TF32 products allowed.

The model (the Williams-Fitzgibbon GPIS of pacman-project/
gaussian-object-modelling): the cloud is centred on its mean and scaled so
that its farthest point lies on the unit sphere; surface points observe 0
(noise `noise_surface`), `n_internal` points at the centre observe -1, and
`n_external` Fibonacci points on a sphere of `external_radius` observe +1.
Tactile contacts observe 0 with the touch noise.  With normals, each
surface point also observes the gradient of f, its unit normal, with ten
times the surface noise.  The covariance is the squared exponential
k(x, x') = sv exp(-|x - x'|^2 / (2 ls^2)).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["fibonacci_sphere", "Observations", "observations", "Posterior", "mll_and_grad",
           "adam", "touch_noise", "capacity"]

ROWS = 2048  # rows of a covariance block built at once


def fibonacci_sphere(n: int, radius: float = 1.0) -> np.ndarray:
    """n quasi-uniform points on a sphere of `radius` about the origin."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = math.pi * (1.0 + math.sqrt(5.0)) * i
    return radius * np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                              np.cos(phi)], axis=1)


def capacity(n_rows: int, block: int, touch_capacity: int) -> int:
    """The session's padded size for n_rows observations and touch_capacity
    touch slots: each rounded up to `block`, the sum (at least 4,096) up to
    a multiple of 1,024.  The touch noise floor is stated in it."""
    def up(v, m):
        return -(-v // m) * m

    total = up(n_rows, block) + up(touch_capacity, block)
    return total if total < 4096 else up(total, 1024)


def touch_noise(model: dict, n_rows: int) -> float:
    """A contact's noise: the configured touch noise, floored at 4 eps C sv
    in the configured dtype (C the session's padded size), below which a
    float32 bordering can turn indefinite."""
    eps = float(np.finfo(model["dtype"]).eps)
    c = capacity(n_rows, model["block"], model["touch_capacity"])
    return max(model["noise_touch"], 4.0 * eps * c * model["signal_variance"])


class Observations:
    """Value observations (x, y, noise) and, optionally, gradient
    observations (xg, g, noise_g) in the normalized frame."""

    def __init__(self, x, y, noise, xg=None, g=None, noise_g=None):
        self.x, self.y, self.noise = x, y, noise
        self.xg, self.g, self.noise_g = xg, g, noise_g

    @property
    def size(self) -> int:
        return self.x.shape[0] + (0 if self.xg is None else 3 * self.xg.shape[0])

    def targets(self) -> torch.Tensor:
        if self.xg is None:
            return self.y
        return torch.cat([self.y, self.g[:, 0], self.g[:, 1], self.g[:, 2]])

    def noises(self) -> torch.Tensor:
        if self.xg is None:
            return self.noise
        return torch.cat([self.noise] + [self.noise_g] * 3)

    def cross(self, q, ls: float, sv: float) -> torch.Tensor:
        """cov(f(q), observations): (M, size)."""
        blocks = [_sqexp(q, self.x, ls, sv)]
        if self.xg is not None:
            k = _sqexp(q, self.xg, ls, sv)
            for d in range(3):
                blocks.append(k * (q[:, d:d + 1] - self.xg[None, :, d]) / ls**2)
        return torch.cat(blocks, dim=1)

    def gram(self, ls: float, sv: float) -> torch.Tensor:
        """The observations' covariance with their noise on the diagonal."""
        n = self.size
        out = torch.empty((n, n), dtype=self.x.dtype, device=self.x.device)
        nv = self.x.shape[0]
        for r0 in range(0, nv, ROWS):
            a = self.x[r0:r0 + ROWS]
            out[r0:r0 + a.shape[0]] = self.cross(a, ls, sv)
        if self.xg is not None:
            ns = self.xg.shape[0]
            out[nv:, :nv] = out[:nv, nv:].T
            for r0 in range(0, ns, ROWS):
                a = self.xg[r0:r0 + ROWS]
                k = _sqexp(a, self.xg, ls, sv)
                diff = [a[:, d:d + 1] - self.xg[None, :, d] for d in range(3)]
                for d in range(3):
                    for e in range(3):
                        blk = -k * diff[d] * diff[e] / ls**4
                        if d == e:
                            blk = blk + k / ls**2
                        out[nv + d * ns + r0:nv + d * ns + r0 + a.shape[0],
                            nv + e * ns:nv + (e + 1) * ns] = blk
        out.diagonal().add_(self.noises())
        return out


def _d2(a, b) -> torch.Tensor:
    d2 = torch.zeros((a.shape[0], b.shape[0]), dtype=a.dtype, device=a.device)
    for d in range(3):
        d2 += (a[:, d:d + 1] - b[None, :, d]) ** 2
    return d2


def _sqexp(a, b, ls: float, sv: float) -> torch.Tensor:
    return sv * torch.exp(-0.5 * _d2(a, b) / ls**2)


def frame(cloud: np.ndarray):
    """(centroid, scale) of the world-to-normalized map x -> (x - c) / s."""
    pts = np.asarray(cloud, np.float64)
    c = pts.mean(axis=0)
    s = float(np.linalg.norm(pts - c, axis=1).max())
    return c, (s if s > 0 else 1.0)


def observations(cloud, model: dict, *, normals=None, touches=None, dtype=torch.float64,
                 device="cpu") -> tuple[Observations, tuple]:
    """The observations of a world-frame cloud (and its normals and tactile
    contacts) in the normalized frame, and that frame."""
    c, s = frame(cloud)
    surf = (np.asarray(cloud, np.float64) - c) / s
    n_in, n_ex = model["n_internal"], model["n_external"]
    internal = fibonacci_sphere(n_in, 0.1) if n_in > 1 else np.zeros((n_in, 3))
    external = fibonacci_sphere(n_ex, model["external_radius"])
    parts_x = [surf, internal, external]
    parts_y = [np.full(len(surf), model["label_surface"]), np.full(n_in, model["label_internal"]),
               np.full(n_ex, model["label_external"])]
    parts_n = [np.full(len(surf), model["noise_surface"]), np.full(n_in, model["noise_internal"]),
               np.full(n_ex, model["noise_external"])]
    n_rows = len(surf) + n_in + n_ex
    if touches is not None and len(touches):
        t = (np.asarray(touches, np.float64) - c) / s
        parts_x.append(t)
        parts_y.append(np.zeros(len(t)))
        parts_n.append(np.full(len(t), touch_noise(model, n_rows)))

    def tensor(parts):
        return torch.as_tensor(np.concatenate(parts), dtype=dtype, device=device)

    obs = Observations(tensor(parts_x), tensor(parts_y), tensor(parts_n))
    if normals is not None:
        nrm = np.asarray(normals, np.float64)
        nrm = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
        obs.xg = torch.as_tensor(surf, dtype=dtype, device=device)
        obs.g = torch.as_tensor(nrm, dtype=dtype, device=device)
        obs.noise_g = torch.full((len(surf),), 10.0 * model["noise_surface"], dtype=dtype,
                                 device=device)
    return obs, (c, s)


class Posterior:
    """The posterior of f given the observations: K = L L^T, W = L^{-1},
    alpha = K^{-1} y; with B = [W^T | alpha], k_q B holds W k_q^T and the
    mean in one product: mean = k_q alpha, var = sv - |W k_q^T|^2."""

    def __init__(self, obs: Observations, ls: float, sv: float):
        self.obs, self.ls, self.sv = obs, ls, sv
        k = obs.gram(ls, sv)
        chol, info = torch.linalg.cholesky_ex(k)
        del k
        if int(info) != 0:
            raise FloatingPointError(f"the reference's factor failed at column {int(info)}")
        alpha = torch.cholesky_solve(obs.targets()[:, None], chol)
        eye = torch.eye(chol.shape[0], dtype=chol.dtype, device=chol.device)
        w = torch.linalg.solve_triangular(chol, eye, upper=False)
        del chol, eye
        self.b = torch.cat([w.T, alpha], dim=1)

    def predict(self, q, rows: int = 1024):
        """(mean, var) at normalized-frame points q (M, 3)."""
        means, variances = [], []
        for r0 in range(0, q.shape[0], rows):
            p = self.obs.cross(q[r0:r0 + rows], self.ls, self.sv) @ self.b
            means.append(p[:, -1])
            variances.append(self.sv - (p[:, :-1] ** 2).sum(dim=1))
        return torch.cat(means), torch.cat(variances)


def mll_and_grad(obs: Observations, ls: float, noise_scale: float, sv: float = 1.0,
                 n_pad: int = 0, pad_noise: float = 0.0):
    """log p(y | X) of value observations whose noise is scaled by
    `noise_scale`, and its gradient in (log ls, log noise_scale).  `n_pad`
    padding rows of noise `pad_noise` and target 0, far from everything,
    add their constant -0.5 log(2 pi pad_noise) each."""
    x, y = obs.x, obs.y
    noise = obs.noise * noise_scale
    k = torch.empty((x.shape[0], x.shape[0]), dtype=x.dtype, device=x.device)
    for r0 in range(0, x.shape[0], ROWS):
        k[r0:r0 + ROWS] = _sqexp(x[r0:r0 + ROWS], x, ls, sv)
    k.diagonal().add_(noise)
    chol, info = torch.linalg.cholesky_ex(k)
    del k
    if int(info) != 0:
        raise FloatingPointError(f"the reference's factor failed at column {int(info)}")
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    n = x.shape[0]
    mll = (-0.5 * float(y @ alpha) - float(torch.log(chol.diagonal()).sum())
           - 0.5 * n * math.log(2.0 * math.pi))
    if n_pad:
        mll -= 0.5 * n_pad * math.log(2.0 * math.pi * pad_noise)
    kinv = torch.cholesky_inverse(chol)
    del chol
    # d mll / d theta = 0.5 tr((alpha alpha^T - K^{-1}) dK / d theta)
    g_ls = 0.0
    for r0 in range(0, n, ROWS):
        a = x[r0:r0 + ROWS]
        d2 = _d2(a, x)
        dk = sv * torch.exp(-0.5 * d2 / ls**2) * d2 / ls**2
        g_ls += 0.5 * float(((alpha[r0:r0 + ROWS, None] * alpha[None, :] - kinv[r0:r0 + ROWS])
                             * dk).sum())
    g_noise = 0.5 * float(((alpha * alpha - kinv.diagonal()) * noise).sum())
    return mll, np.array([g_ls, g_noise])


def adam(value_and_grad, theta0, *, steps: int, lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8):
    """Adam ascending value_and_grad(theta) -> (value, gradient) from theta0:
    each step's (theta, value), the value at the iterate it was taken at."""
    theta = np.asarray(theta0, np.float64).copy()
    m = np.zeros_like(theta)
    v = np.zeros_like(theta)
    out = []
    for t in range(1, steps + 1):
        val, g = value_and_grad(theta)
        out.append((theta.copy(), val))
        g = -np.asarray(g)  # descend on -value
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        theta = theta - lr * (m / (1.0 - b1**t)) / (np.sqrt(v / (1.0 - b2**t)) + eps)
    return out
