"""Tests for the jitted Arnoldi relation builder (functional-lane counterpart of
utils.arnoldi; relation/orthogonality oracles as in test_arnoldi.py)."""

import numpy
import pytest
import jax.numpy as jnp

from krypy_tpu import functional as F

import helpers


@pytest.mark.parametrize("ortho", ["cgs", "cgs2", "mgs", "dmgs", "cgs2_1r"])
@pytest.mark.parametrize(
    "matrix", [helpers.matrix_spd(), helpers.matrix_nonsymm()]
)
@pytest.mark.parametrize("maxiter", [1, 5, 9])
def test_functional_arnoldi_relation(ortho, matrix, maxiter):
    v = jnp.ones(10)
    res = F.arnoldi(jnp.asarray(matrix), v, maxiter=maxiter, ortho=ortho)
    n = int(res.niter)
    assert n <= maxiter
    V = numpy.asarray(res.V)[: n + 1].T
    H = numpy.asarray(res.H)[: n + 1, :n]
    An = numpy.linalg.norm(matrix, 2)
    # Arnoldi relation
    rel = numpy.linalg.norm(matrix @ V[:, :n] - V @ H)
    assert rel <= 1e-12 * An
    # orthogonality: single-pass schemes get the condition-dependent
    # bound class (reference exemption: test_utils.py:530-532)
    tol = 1e-8 if ortho in ("cgs", "mgs") else 1e-13
    assert numpy.linalg.norm(numpy.eye(n + 1) - V.conj().T @ V) <= tol
    # Hessenberg structure with real non-negative subdiagonal
    assert numpy.linalg.norm(numpy.tril(H, -2)) == 0
    sub = numpy.diag(H[1:, :n])
    assert (numpy.real(sub) >= 0).all()


def test_functional_arnoldi_lanczos():
    A = helpers.matrix_spd()
    res = F.arnoldi(jnp.asarray(A), jnp.ones(10), maxiter=8,
                    ortho="lanczos")
    n = int(res.niter)
    V = numpy.asarray(res.V)[: n + 1].T
    H = numpy.asarray(res.H)[: n + 1, :n]
    assert numpy.linalg.norm(A @ V[:, :n] - V @ H) <= 1e-12
    # tridiagonal symmetric
    assert numpy.linalg.norm(H[:n, :n] - H[:n, :n].T) == 0
    assert numpy.linalg.norm(numpy.triu(H[:n, :n], 2)) == 0


def test_functional_arnoldi_invariance():
    """Operator with two distinct eigenvalues: invariance at n=2."""
    A = numpy.diag([1.0] * 8 + [2.0, 2.0])
    res = F.arnoldi(jnp.asarray(A), jnp.ones(10), maxiter=9)
    assert bool(res.invariant)
    assert int(res.niter) == 2
    n = 2
    V = numpy.asarray(res.V)[:n].T
    H = numpy.asarray(res.H)[:n, :n]
    # invariant relation A V_n = V_n H_n
    assert numpy.linalg.norm(A @ V - V @ H) <= 1e-12


def test_functional_arnoldi_preconditioned():
    A = helpers.matrix_spd()
    Md = numpy.linspace(1, 3, 10)
    res = F.arnoldi(
        jnp.asarray(A), jnp.ones(10), maxiter=8, M=lambda x: x / Md
    )
    n = int(res.niter)
    V = numpy.asarray(res.V)[: n + 1].T
    P = numpy.asarray(res.P)[: n + 1].T
    H = numpy.asarray(res.H)[: n + 1, :n]
    MA = numpy.diag(1.0 / Md) @ A
    assert numpy.linalg.norm(MA @ V[:, :n] - V @ H) <= 1e-12
    # dual basis consistency V = M P
    assert numpy.linalg.norm(V - numpy.diag(1.0 / Md) @ P) <= 1e-13
    # M^{-1}-orthonormality: <P, V> = I
    assert (
        numpy.linalg.norm(numpy.eye(n + 1) - P.T @ V) <= 1e-13
    )


def test_functional_vs_eager_arnoldi():
    """The two lanes build the same relation (same H up to fp)."""
    from krypy_tpu import utils

    A = helpers.matrix_nonsymm()
    v = numpy.ones((10, 1))
    V_e, H_e = utils.arnoldi(A, jnp.asarray(v), maxiter=6, ortho="dmgs")
    res = F.arnoldi(jnp.asarray(A), jnp.ones(10), maxiter=6, ortho="dmgs")
    n = int(res.niter)
    numpy.testing.assert_allclose(
        numpy.asarray(res.H)[: n + 1, :n],
        numpy.asarray(H_e),
        atol=1e-12,
    )


@pytest.mark.parametrize(
    "matrix", [helpers.matrix_spd(), helpers.matrix_nonsymm()]
)
@pytest.mark.parametrize("maxiter", [1, 5, 9, 10])
def test_functional_arnoldi_house(matrix, maxiter):
    """Householder scheme: unconditional orthogonality bound
    (inequality (2.4) of Drkošová et al.)."""
    res = F.arnoldi(
        jnp.asarray(matrix), jnp.ones(10), maxiter=maxiter, ortho="house"
    )
    n = int(res.niter)
    inv = bool(res.invariant)
    cols = n if inv else n + 1
    V = numpy.asarray(res.V)[:cols].T
    H = numpy.asarray(res.H)[:cols, :n]
    An = numpy.linalg.norm(matrix, 2)
    assert numpy.linalg.norm(matrix @ V[:, :n] - V @ H) <= 1e-13 * An
    assert (
        numpy.linalg.norm(numpy.eye(cols) - V.conj().T @ V) <= 1e-13
    )
    if maxiter == 10:
        assert inv  # full dimension reached
    # subdiagonal real non-negative
    sub = numpy.diag(H[1:, :n]) if not inv else numpy.diag(H, -1)
    assert (numpy.real(sub) >= 0).all()


def test_functional_arnoldi_house_requires_euclid():
    with pytest.raises(ValueError):
        F.arnoldi(
            jnp.eye(4), jnp.ones(4), maxiter=2, ortho="house",
            M=lambda x: x,
        )
