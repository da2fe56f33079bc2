"""GMRES-polynomial preconditioner (harmonic-Ritz roots, product form).

The reference has no polynomial preconditioning (krypy takes a
user-supplied ``M`` only, krypy/linsys.py:61-78); this is accelerator-native
surface: one application is ``degree`` matvecs and ZERO reductions.
"""

import numpy
import pytest

import jax.numpy as jnp

from krypy_tpu import functional as F, ops


def _moderate_nonsym(n=600, seed=0):
    rng = numpy.random.default_rng(seed)
    d = numpy.linspace(1.0, 100.0, n)
    S = rng.standard_normal((n, n)) * 0.5 / numpy.sqrt(n)
    A = numpy.diag(d) + S - S.T
    b = rng.standard_normal(n)
    return jnp.asarray(A), jnp.asarray(b)


def test_full_degree_is_exact_inverse():
    """degree = n on a diagonal system: the harmonic Ritz values are the
    exact eigenvalues and p(A) = A^{-1} exactly."""
    d = numpy.array([1.0, 2.0, 3.0, 5.0, 8.0, 13.0])
    A = jnp.diag(jnp.asarray(d))
    rng = numpy.random.default_rng(0)
    seed = jnp.asarray(rng.standard_normal(6))
    P = ops.gmres_polynomial_preconditioner(A, 6, seed=seed)
    assert numpy.allclose(
        numpy.sort(P.roots.real), d, atol=1e-10
    )
    v = jnp.asarray(rng.standard_normal(6))
    err = float(jnp.linalg.norm(P(v) - v / jnp.asarray(d)))
    assert err < 1e-12


def test_partial_degree_matches_dense_construction():
    """The real-arithmetic product-form application equals the dense
    (I - prod(I - A/theta_i)) A^{-1} built from the same roots."""
    rng = numpy.random.default_rng(1)
    n = 30
    Am = numpy.diag(numpy.linspace(1, 10, n)) + 0.1 * rng.standard_normal(
        (n, n)
    )
    P = ops.gmres_polynomial_preconditioner(
        jnp.asarray(Am), 6, seed=jnp.asarray(rng.standard_normal(n))
    )
    piA = numpy.eye(n, dtype=complex)
    for th in P.roots:
        piA = piA @ (numpy.eye(n) - Am / th)
    pA = (numpy.eye(n) - piA) @ numpy.linalg.inv(Am)
    assert numpy.abs(pA.imag).max() < 1e-10  # conjugate-closed roots
    v = rng.standard_normal(n)
    out = numpy.asarray(P(jnp.asarray(v)))
    assert numpy.linalg.norm(out - pA.real @ v) <= 1e-12 * numpy.linalg.norm(
        pA.real @ v
    )


def test_outer_iterations_drop_with_degree():
    A, b = _moderate_nonsym()
    r0 = F.gmres(A, b, tol=1e-10, maxiter=400)
    base = int(r0.niter)
    P = ops.gmres_polynomial_preconditioner(A, 8, seed=b)
    r = F.gmres(A, b, Mr=P, tol=1e-10, maxiter=100)
    assert int(r.status) == 0
    assert int(r.niter) * 3 < base  # >= 3x fewer outer iterations
    rel = float(jnp.linalg.norm(b - A @ r.x) / jnp.linalg.norm(b))
    assert rel <= 1e-9


def test_pairs_with_ca_gmres():
    """Polynomial preconditioning composes with the s-step solver: the
    whole iteration is then matvecs + 6/s reductions per step."""
    A, b = _moderate_nonsym()
    P = ops.gmres_polynomial_preconditioner(A, 8, seed=b)
    r = F.ca_gmres(A, b, Mr=P, s=4, basis="newton", tol=1e-9,
                   maxiter=40)
    assert int(r.status) == 0
    rel = float(jnp.linalg.norm(b - A @ r.x) / jnp.linalg.norm(b))
    assert rel <= 1e-8


def test_complex_operator():
    rng = numpy.random.default_rng(2)
    n = 200
    d = numpy.linspace(1, 40, n) + 1j * rng.standard_normal(n)
    Am = numpy.diag(d) + 0.1 * (
        rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    ) / numpy.sqrt(n)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    A = jnp.asarray(Am)
    P = ops.gmres_polynomial_preconditioner(A, 8, seed=jnp.asarray(b))
    r = F.gmres(A, jnp.asarray(b), Mr=P, tol=1e-10, maxiter=60)
    assert int(r.status) == 0
    rel = float(
        jnp.linalg.norm(jnp.asarray(b) - A @ r.x)
        / jnp.linalg.norm(jnp.asarray(b))
    )
    assert rel <= 1e-9


def test_requires_size_information():
    with pytest.raises(ValueError, match="seed"):
        ops.gmres_polynomial_preconditioner(lambda v: v, 4)


def test_stability_check_flags_explosive_products():
    """A spectrum hugging zero makes the partial products explode; the
    guard must refuse rather than return a round-off amplifier."""
    rng = numpy.random.default_rng(3)
    n = 400
    # a tight cluster at 1e-6 plus an extreme outlier: Arnoldi captures
    # both, and |1 - theta_outlier/theta_cluster| ~ 1e9 explodes the
    # partial products
    d = numpy.r_[1e-6 * (1.0 + 1e-3 * numpy.arange(n - 1)), 1e3]
    A = jnp.asarray(numpy.diag(d))
    seed = jnp.asarray(rng.standard_normal(n))
    with pytest.raises(ValueError, match="growth"):
        ops.gmres_polynomial_preconditioner(A, 12, seed=seed)
    # ... and stability_check=False still builds (caller's risk)
    P = ops.gmres_polynomial_preconditioner(
        A, 12, seed=seed, stability_check=False
    )
    assert P.degree == 12


def test_default_seed_follows_operator_dtype():
    """No seed given: the Arnoldi seed must carry the OPERATOR's dtype
    (code-review finding: a float32 default seed silently truncated
    complex operators' Arnoldi relation)."""
    rng = numpy.random.default_rng(4)
    n = 120
    d = numpy.linspace(1, 30, n) + 1j * rng.standard_normal(n) * 0.3
    Am = numpy.diag(d)
    P = ops.gmres_polynomial_preconditioner(jnp.asarray(Am), 6)
    assert numpy.iscomplexobj(P.roots)
    assert numpy.abs(P.roots.imag).max() > 1e-3  # complex spectrum seen
    b = jnp.asarray(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    r = F.gmres(jnp.asarray(Am), b, Mr=P, tol=1e-10, maxiter=60)
    assert int(r.status) == 0
