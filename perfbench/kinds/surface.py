"""Traffic kind `surface`: a cloud in, a dense grid out.

Each request is `start` on one of `clouds` seeded clouds (the
configuration's sphere stretched to an ellipsoid of semi-axes in `axes`
times its radius, in a seeded pose; cycled), then
`evaluate_grid(resolution)`; a unit is a surface.  Checked: the grids of
`check.surfaces` surfaces (the last among them, distinct clouds first) at
`check.points` grid points each.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import clouds, faults
from perfbench.loops import Loop, gap


class Kind(Loop):
    unit = "surface"

    def setup(self):
        from gpis_tpu_torch import ObjectModelSession

        t = self.traffic
        self.clouds = [clouds.make_cloud(self.config["cloud"], self.rng, axes=t.get("axes"))
                       for _ in range(t["clouds"])]
        self.sizes["m"] = t["resolution"] ** 3
        self.session = ObjectModelSession(self.model_config, device=self.device)
        self.outputs = []
        self._surface(self.clouds[0])
        self.outputs.clear()
        self.spans.clear()
        self.i = 0

    def _surface(self, cloud):
        s = self.session
        with self.span("start"):
            s.start(cloud.points, normals=self.normals(cloud))
        self.spans.setdefault("fit_s", []).append(s.stats["fit_s"])
        with self.span("evaluate_grid"):
            mean, var, _ = s.evaluate_grid(self.traffic["resolution"], self.model["grid_extent"])
        self.spans.setdefault("grid_s", []).append(s.stats["grid_s"])
        return mean, var

    def request(self) -> int:
        k = self.i % len(self.clouds)
        self.i += 1
        mean, var = self._surface(self.clouds[k])
        self.outputs.append((k, mean, var))
        return 1

    def compare(self) -> dict:
        chk, r = self.traffic["check"], self.traffic["resolution"]
        n = len(self.outputs)
        if n == 0:
            return {"mean_gap": math.inf, "var_gap": math.inf}
        rng = np.random.default_rng([self.seed, 2])
        # The last surface and others drawn from the seed, of distinct clouds
        # first.
        order = [n - 1] + [int(p) for p in rng.permutation(n - 1)]
        first, seen = [], set()
        for p in order:
            if self.outputs[p][0] not in seen:
                first.append(p)
                seen.add(self.outputs[p][0])
        picks = (first + [p for p in order if p not in first])[:chk["surfaces"]]
        axis = torch.linspace(-self.model["grid_extent"], self.model["grid_extent"], r,
                              dtype=torch.float32).double().numpy()
        gaps = {"mean_gap": 0.0, "var_gap": 0.0}
        sv = self.model["signal_variance"]
        for p in picks:
            k, mean, var = self.outputs[p]
            idx = rng.choice(r**3, size=min(chk["points"], r**3), replace=False)
            i, j, l = np.unravel_index(idx, (r, r, r))
            q = torch.as_tensor(np.stack([axis[i], axis[j], axis[l]], axis=1),
                                device=self.device)
            post, _ = self.posterior(self.clouds[k])
            m_ref, v_ref = post.predict(q)
            del post
            if self.control:
                got_m, got_v = self.control_answer(self.clouds[k], q)
            else:
                got_m, got_v = mean.reshape(-1)[idx], var.reshape(-1)[idx]
            gaps["mean_gap"] = max(gaps["mean_gap"], gap(got_m, m_ref))
            gaps["var_gap"] = max(gaps["var_gap"], gap(got_v, v_ref) / sv)
        return gaps


def _stale_start():
    """`start` keeps the model it has: the state left unchanged."""
    from gpis_tpu_torch.api.session import ObjectModelSession as S

    def start(old):
        def f(self, points, **kw):
            return self if self.model is not None else old(self, points, **kw)
        return f
    return faults.patch(S, "start", start)


def _half_grid():
    """Half the grid's queries predicted, each standing for its neighbour."""
    from gpis_tpu_torch.gp import regression

    return faults.patch(regression, "predict", faults.half_predict)


def _altered_grid():
    """The grid's mean moved where it is produced."""
    from gpis_tpu_torch.api.session import ObjectModelSession as S

    def grid(old):
        def f(self, *a, **kw):
            mean, var, axis = old(self, *a, **kw)
            return mean + faults.SHIFT, var, axis
        return f
    return faults.patch(S, "evaluate_grid", grid)


FAULTS = {"unchanged": _stale_start, "half": _half_grid, "altered": _altered_grid}
