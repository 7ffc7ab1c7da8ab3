"""Traffic kind `hyperopt`: marginal-likelihood steps on one started model.

The session is started at `start_lengthscale`; each request puts that
started model back and calls `optimize_hyperparameters(steps=,
learning_rate=)`; a unit is a marginal-likelihood step.  Checked: the last
call's MLL and lengthscale at every step against the reference's own Adam
in float64 from the same start, and its refit's posterior at
`check.points` points against the reference's at the call's optimum.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import clouds, faults
from perfbench.loops import Loop, gap, normalized, sample_points, tf32
from perfbench.reference import gp as ref

NAMES = ("mll_gap", "ls_gap", "mean_gap", "var_gap")


class Kind(Loop):
    unit = "step"

    def setup(self):
        from gpis_tpu_torch import ObjectModelSession

        t = self.traffic
        self.cloud = clouds.make_cloud(self.config["cloud"], self.rng)
        self.session = ObjectModelSession(self.model_config, device=self.device)
        self.params0 = {"lengthscale": t["start_lengthscale"],
                        "signal_variance": self.model["signal_variance"]}
        with self.span("start"):
            self.session.start(self.cloud.points, normals=self.normals(self.cloud),
                               params=self.params0)
        self.started = self.session.model
        self.results = []
        self.request(steps=1)  # every step of a call has the same shapes
        self.results.clear()
        self.spans.clear()

    def request(self, steps: int | None = None) -> int:
        t = self.traffic
        self.session.model = self.started
        with self.span("optimize_hyperparameters"):
            res = self.session.optimize_hyperparameters(steps=steps or t["steps"],
                                                        learning_rate=t["learning_rate"])
        self.results.append(res)
        return len(res.history)

    def collect(self):
        self.query = sample_points(self.cloud, self.check_rng, self.traffic["check"]["points"])
        self.got = self.session.query(self.query) if self.results else None

    def release(self):
        self.started = None
        super().release()

    def compare(self) -> dict:
        if not self.results:
            return {k: math.inf for k in NAMES}
        res = self.results[-1]
        mll_ref, ls_ref = self._trajectory(len(res.history), torch.float64)
        if self.control:
            with tf32():
                hist, ls_got = self._trajectory(len(res.history), torch.float32)
        else:
            hist = np.asarray(res.history, np.float64)
            ls_got = np.asarray(res.lengthscale_history, np.float64)
        sv = self.model["signal_variance"]
        out = {"mll_gap": float(np.max(np.abs(hist - mll_ref) / np.abs(mll_ref)))
               if np.isfinite(hist).all() else math.inf,
               "ls_gap": float(np.max(np.abs(ls_got - ls_ref) / ls_ref))
               if np.isfinite(ls_got).all() else math.inf}
        fit = {"ls": res.params["lengthscale"], "noise_scale": res.noise_scale}
        post, frame = self.posterior(self.cloud, **fit)
        q = normalized(self.query, frame, self.device)
        m_ref, v_ref = post.predict(q)
        del post
        got = self.control_answer(self.cloud, q, **fit) if self.control else self.got
        out["mean_gap"] = gap(got[0], m_ref)
        out["var_gap"] = gap(got[1], v_ref) / sv
        return out

    def _trajectory(self, steps: int, dtype):
        """The reference's Adam from the traffic's start: each step's MLL and
        lengthscale."""
        t = self.traffic
        obs, _ = ref.observations(self.cloud.points, self.model, dtype=dtype, device=self.device)
        n_rows = obs.x.shape[0]
        n_pad = ref.capacity(n_rows, self.model["block"], 0) - n_rows

        def value_and_grad(theta):
            return ref.mll_and_grad(obs, math.exp(theta[0]), math.exp(theta[1]),
                                    self.model["signal_variance"], n_pad=n_pad,
                                    pad_noise=self.model["pad_noise"])

        try:
            out = ref.adam(value_and_grad, [math.log(t["start_lengthscale"]), 0.0], steps=steps,
                           lr=t["learning_rate"])
        except FloatingPointError:
            return np.full(steps, np.nan), np.full(steps, np.nan)
        return (np.array([v for _, v in out]), np.array([math.exp(th[0]) for th, _ in out]))


def _frozen_adam():
    """Adam's step leaves the parameters as they were."""
    return faults.patch(torch.optim.Adam, "step", lambda old: lambda self, *a, **k: None)


def _half_mll():
    """The MLL over every other row, doubled to stand for the whole."""
    from gpis_tpu_torch.gp import regression

    def mll(old):
        def f(kernel, xp, yp, noisep, params, **kw):
            return 2.0 * old(kernel, xp[::2].contiguous(), yp[::2].contiguous(),
                             noisep[::2].contiguous(), params, **kw)
        return f
    return faults.patch(regression, "log_marginal_likelihood", mll)


def _altered_history():
    """Each step's MLL moved where the optimizer records it."""
    from gpis_tpu_torch.gp import hyperopt

    def minimize(old):
        def f(*a, **kw):
            best, val, history, log_ls = old(*a, **kw)
            return best, val, [h * (1.0 + faults.SHIFT) for h in history], log_ls
        return f
    return faults.patch(hyperopt, "_minimize", minimize)


def _stale_refit():
    """The refit leaves the started model in place: the optimum is reported
    but not fitted."""
    from gpis_tpu_torch.api.session import ObjectModelSession as S

    def optimize(old):
        def f(self, **kw):
            started = self.model
            res = old(self, **kw)
            self.model = started
            return res
        return f
    return faults.patch(S, "optimize_hyperparameters", optimize)


FAULTS = {"unchanged": _frozen_adam, "half": _half_mll, "altered": _altered_history,
          "unchanged_refit": _stale_refit}
