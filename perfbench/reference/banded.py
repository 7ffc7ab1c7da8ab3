"""Plain reference of the GPIS posterior for a system no single device can
factor: the Gram of `reference/gp.py`'s observations and covariance, its
Cholesky factor kept in row bands over a list of devices, and the posterior
at query points by forward substitution through the bands.

Written from the model's definition in plain PyTorch, importing nothing of
the package under test; one process drives every device (no process
group).  Rows are split into contiguous bands of a multiple of `block`
rows, band p on devices[p]; band p stores only the columns left of its
last row, where the lower triangle lives (at C 147,456 over four devices
the last band is 36,864 x 147,456, 43.5 GB in float64).

The factor is right-looking, a block column at a time: the band that owns
the diagonal block factors it, every band at or below solves its rows of
the block column against it, and each band subtracts the column's outer
product from its trailing rows, after the column's rows it needs are copied
over from the bands above.  With V = L^{-1} [k(X, q) | y] (solved band by
band: a band's rows take the product with the earlier bands' V, then its
own diagonal triangle), the posterior is mean = V_q^T V_y and
var = sv - |V_q|^2 column-wise, which is k_q alpha and
sv - k_q K^{-1} k_q^T without forming alpha or W.

Runs are in float64; the control runs the same code in float32 with TF32
products allowed.  A factor that meets a non-positive pivot raises
FloatingPointError.
"""

from __future__ import annotations

import torch

from perfbench.reference import gp

__all__ = ["BandedPosterior", "band_edges"]

BLOCK = 512  # rows of a block column


def band_edges(c: int, n_bands: int, block: int = BLOCK) -> list[int]:
    """The first row of each band and C: bands of equal whole blocks, the
    last one short where C is not a multiple."""
    rows = -(-c // (n_bands * block)) * block
    return [min(p * rows, c) for p in range(n_bands)] + [c]


class BandedPosterior:
    """The posterior of f given value observations (`gp.Observations`
    without gradients), its factor banded over `devices`."""

    def __init__(self, obs: gp.Observations, ls: float, sv: float, devices, *,
                 block: int = BLOCK):
        if obs.xg is not None:
            raise ValueError("the banded reference takes value observations only")
        self.ls, self.sv, self.block = ls, sv, block
        self.devices = [torch.device(d) for d in devices]
        c = obs.x.shape[0]
        self.edges = band_edges(c, len(self.devices), block)
        self.x = [obs.x.to(d) for d in self.devices]
        self.y = [obs.y.to(d) for d in self.devices]
        self.bands = []
        for p, dev in enumerate(self.devices):
            r0, r1 = self.edges[p], self.edges[p + 1]
            cols = gp.Observations(self.x[p][:r1], None, None)
            band = torch.empty((r1 - r0, r1), dtype=obs.x.dtype, device=dev)
            for a in range(r0, r1, gp.ROWS):
                b = min(a + gp.ROWS, r1)
                band[a - r0:b - r0] = cols.cross(self.x[p][a:b], ls, sv)
            band[:, r0:r1].diagonal().add_(obs.noise[r0:r1].to(dev))
            self.bands.append(band)
        self._factor()

    def _owner(self, row: int) -> int:
        return max(p for p in range(len(self.devices)) if self.edges[p] <= row)

    def _factor(self):
        infos = []
        c = self.edges[-1]
        for j0 in range(0, c, self.block):
            j1 = min(j0 + self.block, c)
            o = self._owner(j0)
            diag = self.bands[o][j0 - self.edges[o]:j1 - self.edges[o], j0:j1]
            ljj, info = torch.linalg.cholesky_ex(diag)
            infos.append(info)
            diag.copy_(ljj)
            # Each band's rows of the block column below the diagonal block.
            for p in range(o, len(self.devices)):
                r0, r1 = self.edges[p], self.edges[p + 1]
                lo = max(j1, r0)
                if lo < r1:
                    rows = self.bands[p][lo - r0:, j0:j1]
                    rows.copy_(torch.linalg.solve_triangular(ljj.to(self.devices[p]).T, rows,
                                                             upper=True, left=False))
            # Each band's trailing update, against the column's rows j1 ..
            # the band's last row, gathered from the bands that hold them.
            for p in range(o, len(self.devices)):
                r0, r1 = self.edges[p], self.edges[p + 1]
                lo = max(j1, r0)
                if lo >= r1:
                    continue
                dev = self.devices[p]
                col = torch.cat([self.bands[q][max(j1, self.edges[q]) - self.edges[q]:, j0:j1]
                                 .to(dev) for q in range(o, p + 1)
                                 if max(j1, self.edges[q]) < self.edges[q + 1]])
                self.bands[p][lo - r0:, j1:r1].addmm_(self.bands[p][lo - r0:, j0:j1], col.T,
                                                      alpha=-1.0)
        bad = [j for j, info in enumerate(infos) if int(info)]  # after the last launch
        if bad:
            raise FloatingPointError(f"the banded reference's factor failed at block column "
                                     f"{bad[0]} (row {bad[0] * self.block})")

    def predict(self, q: torch.Tensor, rows: int = 4096):
        """(mean, var) at normalized-frame points q (M, 3), on q's device."""
        means, variances = [], []
        for a in range(0, q.shape[0], rows):
            m, v = self._predict(q[a:a + rows])
            means.append(m)
            variances.append(v)
        return torch.cat(means), torch.cat(variances)

    def _predict(self, q: torch.Tensor):
        m = q.shape[0]
        solved = []  # V's rows band by band, each on its band's device
        mean = torch.zeros((m,), dtype=q.dtype, device=q.device)
        quad = torch.zeros((m,), dtype=q.dtype, device=q.device)
        for p, dev in enumerate(self.devices):
            r0, r1 = self.edges[p], self.edges[p + 1]
            if r0 == r1:
                continue
            rhs = torch.cat([gp.Observations(q.to(dev), None, None).cross(self.x[p][r0:r1],
                                                                          self.ls, self.sv),
                             self.y[p][r0:r1, None]], dim=1)
            if r0:
                before = torch.cat([v.to(dev) for v in solved])
                rhs.addmm_(self.bands[p][:, :r0], before, alpha=-1.0)
                del before
            v = torch.linalg.solve_triangular(self.bands[p][:, r0:r1], rhs, upper=False)
            solved.append(v)
            mean += (v[:, :m].T @ v[:, m]).to(q.device)
            quad += (v[:, :m] ** 2).sum(dim=0).to(q.device)
        return mean, self.sv - quad
