"""Traffic kind `explore`: the explore-and-touch loop, object after object.

`clouds` seeded clouds, each the configuration's sphere without its cap
z > `cap_z` (the side a fixed camera does not see, so the cap stays on +z)
in a seeded pose (`rotation`: "yaw", a spin about z, with a translation);
`model` overrides (the touch slots).  Each request is `next_best_path`,
then `update` with `contacts` contacts along the path, projected radially
onto the true sphere; when the next batch would not fit in the slots, the
object is done and the session starts on the next cloud inside that
request.  A unit is a round.  Checked: the paths of `check.rounds` rounds
of the last object (the last among them): their poses on the reference's
surface and their target's variance (one number, the larger gap); and the
final posterior at that object's contacts and `check.points` points.
"""

from __future__ import annotations

import math

import numpy as np

from perfbench import clouds, faults
from perfbench.loops import Loop, gap, normalized, sample_points

NAMES = ("path_gap", "mean_gap", "var_gap")


class Kind(Loop):
    unit = "round"

    def setup(self):
        from gpis_tpu_torch import ObjectModelSession
        from gpis_tpu_torch.config import ExploreConfig

        t = self.traffic
        self.clouds = [clouds.make_cloud(self.config["cloud"], self.rng, cap_z=t["cap_z"],
                                         rotation=t.get("rotation", "uniform"))
                       for _ in range(t["clouds"])]
        self.session = ObjectModelSession(self.model_config, ExploreConfig(**t.get("explore", {})),
                                          device=self.device)
        self.rounds, self.episode = [], 0
        self._start()
        self.request()
        self.episode = 0
        self._start()
        self.rounds.clear()
        self.spans.clear()

    def _start(self):
        self.cloud = self.clouds[self.episode % len(self.clouds)]
        with self.span("start"):
            self.session.start(self.cloud.points, normals=self.normals(self.cloud))
        self.episode += 1
        self.touches = np.zeros((0, 3), np.float32)

    def request(self) -> int:
        k = self.traffic["contacts"]
        m = self.session.model
        if m.n_touch + k > m.capacity - m.n0:
            self._start()
        with self.span("next_best_path"):
            res = self.session.next_best_path()
        contacts = clouds.path_contacts(res.path, self.cloud, k)
        with self.span("update"):
            self.session.update(contacts)
        self.rounds.append({"episode": self.episode, "before": len(self.touches),
                            "path": res.path, "charts": len(res.charts),
                            "target_variance": float(res.target_variance)})
        self.touches = np.concatenate([self.touches, contacts])
        return 1

    def collect(self):
        pts = sample_points(self.cloud, self.check_rng, self.traffic["check"]["points"])
        self.query = np.concatenate([self.touches, pts])
        self.got = self.session.query(self.query) if self.rounds else None

    def compare(self) -> dict:
        if not self.rounds:
            return {k: math.inf for k in NAMES}
        sv, last = self.model["signal_variance"], self.rounds[-1]["episode"]
        mine = [r for r in self.rounds if r["episode"] == last]
        n = len(mine)
        rng = np.random.default_rng([self.seed, 2])
        picks = [n - 1] + list(rng.permutation(n - 1)[:max(0, self.traffic["check"]["rounds"] - 1)])
        out = {"path_gap": 0.0}
        for p in picks:
            r = mine[p]
            before = self.touches[:r["before"]]
            post, frame = self.posterior(self.cloud, touches=before)
            q = normalized(r["path"], frame, self.device)
            m_ref, v_ref = post.predict(q)
            del post
            if self.control:
                # Where the control's own projection would put the path: off
                # the reference's surface by the control's error there.
                got_m, got_v = self.control_answer(self.cloud, q, touches=before)
                got_v = got_v[-1:]
            else:
                got_m, got_v = np.zeros(len(r["path"])), [r["target_variance"]]
            # The path's poses lie on the surface (f = 0) and its target's
            # variance is the posterior's there: one number for the path.
            out["path_gap"] = max(out["path_gap"], gap(got_m, m_ref),
                                  gap(got_v, v_ref[-1:]) / sv)
        post, frame = self.posterior(self.cloud, touches=self.touches)
        q = normalized(self.query, frame, self.device)
        m_ref, v_ref = post.predict(q)
        del post
        got = self.control_answer(self.cloud, q, touches=self.touches) if self.control else self.got
        out["mean_gap"] = gap(got[0], m_ref)
        out["var_gap"] = gap(got[1], v_ref) / sv
        return out


def _dropped_update():
    """`update` keeps the model as it was: the contacts are lost."""
    from gpis_tpu_torch.api.session import ObjectModelSession as S

    return faults.patch(S, "update", lambda old: lambda self, pts, **kw: self)


def _half_update():
    """Half of each batch of contacts reaches the model."""
    from gpis_tpu_torch.api.session import ObjectModelSession as S

    return faults.patch(S, "update", lambda old: lambda self, pts, **kw: old(
        self, np.asarray(pts)[: len(pts) // 2], **kw))


def _altered_path():
    """The returned path moved off the surface along its normals."""
    from gpis_tpu_torch.api.session import ObjectModelSession as S

    def nbp(old):
        def f(self, **kw):
            res = old(self, **kw)
            res.path = res.path + faults.SHIFT * float(self.frame.scale) * res.normals
            return res
        return f
    return faults.patch(S, "next_best_path", nbp)


FAULTS = {"unchanged": _dropped_update, "half": _half_update, "altered": _altered_path}
