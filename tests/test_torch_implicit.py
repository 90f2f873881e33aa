"""The port's differentiable solve (``make_implicit_solver``) against central
differences and against ``jax.grad`` of the JAX package's solver
(oracle: tests/test_implicit.py), in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu.problems import bratu1d as jb1
from newtonkrylov_tpu_torch.problems import bratu1d as tb1
from newtonkrylov_tpu_torch.problems import bratu2d as tb2

F64 = torch.float64


def _bratu(mod, n):
    dx = 1.0 / (n + 1)
    return lambda u, lam: mod.residual_scaled(u, mod.Params(dx=dx, lam=lam))


@pytest.mark.parametrize("adjoint_algo", ["bicgstab", "cg"])
def test_scalar_parameter_gradient(adjoint_algo):
    """d(Σu*)/dλ of the 1-D Bratu root (n = 64, λ = 3, a 0-d tensor): the
    JAX package's ``jax.grad`` within rtol 1e-6, and central differences
    (ε = 1e-6) within rtol 1e-5 (test_implicit.py::
    test_scalar_parameter_gradient_vs_fd), for both adjoint solvers."""
    n = 64
    u0 = np.asarray(jb1.initial_guess(n))
    solve_j = nk.make_implicit_solver(_bratu(jb1, n), algo="cg", tol_rel=1e-12,
                                      adjoint_algo=adjoint_algo)
    g_jax = float(jax.grad(lambda lam: jnp.sum(solve_j(jnp.asarray(u0), lam)))(3.0))

    solve = nkt.make_implicit_solver(_bratu(tb1, n), algo="cg", tol_rel=1e-12,
                                     adjoint_algo=adjoint_algo)
    u0t = torch.tensor(u0, dtype=F64)
    lam = torch.tensor(3.0, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(solve(u0t, lam).sum(), lam)
    np.testing.assert_allclose(float(g), g_jax, rtol=1e-6)

    eps = 1e-6
    loss = lambda l: float(solve(u0t, torch.tensor(l, dtype=F64)).sum())  # noqa: E731
    fd = (loss(3.0 + eps) - loss(3.0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g), fd, rtol=1e-5)


def test_dict_parameter_gradient():
    """Gradients to every tensor leaf of a dict p, through restarted GMRES
    forward and BiCGStab adjoint (test_implicit.py::
    test_pytree_parameter_gradient): the JAX package's ``jax.grad`` within
    rtol 1e-6 on both leaves, and central differences within rtol 1e-4."""
    n = 32

    def F_j(u, p):
        up = jnp.pad(u, 1)
        return up[2:] - 2.0 * u + up[:-2] + p["scale"] * jnp.exp(u) + p["source"]

    def F_t(u, p):
        up = torch.nn.functional.pad(u, (1, 1))
        return up[2:] - 2.0 * u + up[:-2] + p["scale"] * torch.exp(u) + p["source"]

    kw = dict(algo="gmres", tol_rel=1e-12, krylov_kwargs={"restart": 32})
    solve_j = nk.make_implicit_solver(F_j, **kw)
    pj = {"scale": jnp.asarray(1e-3), "source": jnp.full(n, 1e-3)}
    gj = jax.grad(lambda p: jnp.sum(solve_j(jnp.zeros(n), p) ** 2))(pj)

    solve = nkt.make_implicit_solver(F_t, **kw)
    u0 = torch.zeros(n, dtype=F64)

    def loss(p):
        return (solve(u0, p) ** 2).sum()

    p = {"scale": torch.tensor(1e-3, dtype=F64, requires_grad=True),
         "source": torch.full((n,), 1e-3, dtype=F64, requires_grad=True)}
    g_scale, g_source = torch.autograd.grad(loss(p), (p["scale"], p["source"]))
    np.testing.assert_allclose(float(g_scale), float(gj["scale"]), rtol=1e-6)
    np.testing.assert_allclose(g_source.numpy(), np.asarray(gj["source"]), rtol=1e-6)

    eps = 1e-6
    with torch.no_grad():
        lp = lambda s: float(loss({"scale": torch.tensor(s, dtype=F64),  # noqa: E731
                                   "source": p["source"]}))
        fd = (lp(1e-3 + eps) - lp(1e-3 - eps)) / (2 * eps)
        e = torch.zeros(n, dtype=F64)
        e[7] = eps
        fdf = (float(loss({"scale": p["scale"], "source": p["source"] + e}))
               - float(loss({"scale": p["scale"], "source": p["source"] - e}))) / (2 * eps)
    np.testing.assert_allclose(float(g_scale), fd, rtol=1e-4)
    np.testing.assert_allclose(float(g_source[7]), fdf, rtol=1e-4)


def test_named_tuple_parameter_with_fixed_fields():
    """A NamedTuple p mixing a tensor field and a Python float: the
    gradient flows to the tensor, the float stays fixed."""
    n = 48
    solve = nkt.make_implicit_solver(tb1.residual_scaled, algo="cg", tol_rel=1e-12)
    u0 = tb1.initial_guess(n, device="cpu")
    lam = torch.tensor(2.0, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(solve(u0, tb1.Params(dx=1.0 / (n + 1), lam=lam)).sum(), lam)
    (g2,) = torch.autograd.grad(
        nkt.make_implicit_solver(_bratu(tb1, n), algo="cg", tol_rel=1e-12)(u0, lam).sum(),
        lam)
    np.testing.assert_allclose(float(g), float(g2), rtol=1e-12)


def test_no_gradient_to_initial_guess():
    """The root does not depend on u₀: its cotangent is exactly zero."""
    n = 16

    def F(u, lam):
        up = torch.nn.functional.pad(u, (1, 1))
        return up[2:] - 2.0 * u + up[:-2] + lam * torch.exp(u) * 1e-3

    solve = nkt.make_implicit_solver(F, algo="cg", tol_rel=1e-12)
    u0 = torch.full((n,), 0.1, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(solve(u0, torch.tensor(1.0, dtype=F64)).sum(), u0)
    assert torch.equal(g, torch.zeros(n, dtype=F64))


def test_aligned_residual_has_no_adjoint():
    """The aligned Bratu residual's JVP is the K1 kernel, which has no
    transpose (ROADMAP.md Queue 3 item 15): the backward raises.  (Its
    scale is a float of the kernel's op, so the tensor parameter here is an
    additive source.)"""
    n = 16
    u0, p, space = tb2.aligned_setup(n, lam=5.0, dtype=F64, device="cpu")
    solve = nkt.make_implicit_solver(
        lambda u, q: tb2.residual_scaled_aligned(u, p) + q * space.mask,
        algo="cg", space=space)
    q = torch.zeros_like(u0, requires_grad=True)
    u = solve(u0, q)
    with pytest.raises(NotImplementedError, match="item 15"):
        torch.autograd.grad(u.sum(), q)
