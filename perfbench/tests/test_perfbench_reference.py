"""The plain reference against hand-worked cases."""

import math

import numpy as np
import pytest
import torch

from perfbench.reference import gp as ref

MODEL = {"lengthscale": 0.5, "signal_variance": 1.0, "noise_surface": 1e-3, "noise_internal": 1e-4,
         "noise_external": 1e-4, "noise_touch": 1e-6, "label_surface": 0.0,
         "label_internal": -1.0, "label_external": 1.0, "external_radius": 2.0, "n_external": 6,
         "n_internal": 1, "dtype": "float32", "block": 128, "touch_capacity": 256,
         "pad_noise": 1e12}


def _obs(x, y, noise):
    t = torch.float64
    return ref.Observations(torch.tensor(x, dtype=t), torch.tensor(y, dtype=t),
                            torch.tensor(noise, dtype=t))


def test_one_point_posterior_closed_form():
    ls, sv, n = 0.7, 2.0, 0.1
    post = ref.Posterior(_obs([[0.0, 0.0, 0.0]], [1.5], [n]), ls, sv)
    q = torch.tensor([[0.3, -0.2, 0.1], [0.0, 0.0, 0.0]], dtype=torch.float64)
    k = sv * torch.exp(-0.5 * (q**2).sum(1) / ls**2)
    mean, var = post.predict(q)
    assert torch.allclose(mean, k * 1.5 / (sv + n), rtol=1e-12)
    assert torch.allclose(var, sv - k * k / (sv + n), rtol=1e-12)


def test_gradient_observation_covariances_are_the_kernels_derivatives():
    ls, sv = 0.6, 1.3
    a = np.array([[0.1, -0.3, 0.2]])
    b = np.array([[-0.2, 0.4, 0.05]])

    def k(x, y):
        return sv * math.exp(-0.5 * float(((x - y) ** 2).sum()) / ls**2)

    h = 1e-5
    t = torch.float64
    obs = ref.Observations(torch.tensor(a, dtype=t), torch.zeros(1, dtype=t),
                           torch.zeros(1, dtype=t), xg=torch.tensor(b, dtype=t),
                           g=torch.zeros((1, 3), dtype=t), noise_g=torch.zeros(1, dtype=t))
    g = obs.gram(ls, sv).numpy()  # rows [value at a | d/dx_d at b for d = 0, 1, 2]
    e = np.eye(3)
    for d in range(3):
        # cov(f(a), d_d f(b)) = d k(a, b) / d b_d
        fd = (k(a[0], b[0] + h * e[d]) - k(a[0], b[0] - h * e[d])) / (2 * h)
        assert g[0, 1 + d] == pytest.approx(fd, rel=1e-7)
        assert g[1 + d, 0] == g[0, 1 + d]
        for f in range(3):
            # cov(d_d f(b), d_f f(b')) at b' = b: d^2 k / d b_d d b'_f = delta / ls^2
            assert g[1 + d, 1 + f] == pytest.approx(sv / ls**2 if d == f else 0.0, abs=1e-12)
    q = torch.tensor(a, dtype=t)
    cross = obs.cross(q, ls, sv).numpy()
    assert cross[0, 0] == pytest.approx(k(a[0], a[0]))
    for d in range(3):
        fd = (k(a[0], b[0] + h * e[d]) - k(a[0], b[0] - h * e[d])) / (2 * h)
        assert cross[0, 1 + d] == pytest.approx(fd, rel=1e-7)


def test_mll_two_points_closed_form_and_gradient():
    ls, s = 0.8, 1.7
    x = [[0.0, 0.0, 0.0], [0.4, 0.0, 0.0]]
    y, noise = [1.0, -0.5], [0.2, 0.3]
    obs = _obs(x, y, noise)
    mll, grad = ref.mll_and_grad(obs, ls, s)

    def direct(ls, s):
        k12 = math.exp(-0.5 * 0.16 / ls**2)
        kmat = np.array([[1 + 0.2 * s, k12], [k12, 1 + 0.3 * s]])
        yv = np.array(y)
        return (-0.5 * yv @ np.linalg.solve(kmat, yv) - 0.5 * math.log(np.linalg.det(kmat))
                - math.log(2 * math.pi))

    assert mll == pytest.approx(direct(ls, s), rel=1e-12)
    h = 1e-6
    fd_ls = (direct(ls * math.exp(h), s) - direct(ls * math.exp(-h), s)) / (2 * h)
    fd_s = (direct(ls, s * math.exp(h)) - direct(ls, s * math.exp(-h))) / (2 * h)
    assert grad == pytest.approx([fd_ls, fd_s], rel=1e-6)
    # Padding rows add -0.5 log(2 pi pad_noise) each.
    padded, _ = ref.mll_and_grad(obs, ls, s, n_pad=3, pad_noise=1e12)
    assert padded == pytest.approx(mll - 1.5 * math.log(2 * math.pi * 1e12), rel=1e-12)


def test_adam_matches_torch_adam():
    def vg(theta):  # ascend -|theta - (1, -2)|^2
        d = theta - np.array([1.0, -2.0])
        return -float(d @ d), -2.0 * d

    got = ref.adam(vg, [0.0, 0.0], steps=5, lr=0.1)
    t = torch.zeros(2, dtype=torch.float64, requires_grad=True)
    opt = torch.optim.Adam([t], lr=0.1, betas=(0.9, 0.999), eps=1e-8)
    for theta, val in got:
        assert np.allclose(theta, t.detach().numpy(), rtol=0, atol=1e-15)
        opt.zero_grad()
        loss = ((t - torch.tensor([1.0, -2.0], dtype=torch.float64)) ** 2).sum()
        assert val == pytest.approx(-loss.item(), rel=1e-14)
        loss.backward()
        opt.step()


def test_observations_frame_labels_and_touch_noise():
    cloud = np.array([[1.0, 1.0, 1.0], [3.0, 1.0, 1.0], [2.0, 2.0, 1.0], [2.0, 0.0, 1.0]])
    touches = np.array([[2.0, 1.0, 2.0]])
    obs, (c, s) = ref.observations(cloud, MODEL, touches=touches)
    assert np.allclose(c, [2.0, 1.0, 1.0]) and s == 1.0
    assert obs.x.shape == (4 + 1 + 6 + 1, 3)
    assert torch.allclose(obs.x[:4].norm(dim=1), torch.ones(4, dtype=torch.float64))
    assert torch.equal(obs.x[4], torch.zeros(3, dtype=torch.float64))
    assert torch.allclose(obs.x[5:11].norm(dim=1), torch.full((6,), 2.0, dtype=torch.float64))
    assert obs.y.tolist() == [0.0] * 4 + [-1.0] + [1.0] * 6 + [0.0]
    # 11 rows and 256 slots pad to 128 + 256 = 384 < 4096: the float32
    # floor 4 eps 384 is above the configured 1e-6.
    floor = 4.0 * float(np.finfo(np.float32).eps) * 384
    assert obs.noise[-1].item() == pytest.approx(floor)
    assert obs.noise[:4].tolist() == [1e-3] * 4
    assert ref.capacity(16384, 128, 256) == 17408
    assert ref.capacity(16384, 128, 0) == 16384


def test_joint_posterior_reproduces_its_observations():
    # With small noise the posterior mean interpolates the values and the
    # gradient observations pull the mean's slope at the surface point.
    pts = ref.fibonacci_sphere(40) * 0.5
    model = dict(MODEL, lengthscale=0.6)
    obs, _ = ref.observations(pts, model, normals=pts)
    post = ref.Posterior(obs, 0.6, 1.0)
    x0 = obs.x[:1]
    h = 1e-4
    mean0, _ = post.predict(x0)
    assert abs(mean0.item()) < 5e-3
    n0 = obs.g[0]
    up, _ = post.predict(x0 + h * n0)
    dn, _ = post.predict(x0 - h * n0)
    assert ((up - dn) / (2 * h)).item() == pytest.approx(1.0, abs=0.1)
