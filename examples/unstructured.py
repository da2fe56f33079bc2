"""Off-grid workflow: a scipy sparse matrix through the accelerator-native
unstructured lane, end to end.

1. reorder for bandwidth (reverse Cuthill-McKee), so the matrix fits the
   gather-free DIA format;
2. `ops.dia_from_scipy`: the accelerator-native sparse matvec (one dense vector
   per occupied diagonal, roll-based, zero gathers -- 51x faster than
   BCOO on-chip at 65k dof / 1.2M nnz);
3. preconditioning off the grid: `block_jacobi_preconditioner` (SPD, for
   CG) and `spai_preconditioner` (nonsymmetric, for GMRES, with its
   ||AM - I||_F quality certificate);
4. batched solves: `jax.vmap` over the functional core -- many
   independent systems in ONE device program.
"""

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

import jax
import jax.numpy as jnp

import krypy_tpu  # noqa: F401 -- enables the x64/precision policy
from krypy_tpu import functional as F, ops


def build_graph_operator(N=4096, deg=6, band=48, seed=7):
    """An irregular-graph Laplacian whose nodes arrive in a SCRAMBLED
    assembly order (as unstructured-mesh matrices do): the coupling
    graph is local (bandwidth ~`band` in the right ordering), but the
    natural ordering scatters it over thousands of diagonals -- the
    case RCM exists for."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(N), deg)
    cols = (rows + rng.integers(1, band, rows.size)) % N
    W = sp.coo_matrix(
        (rng.uniform(0.5, 2.0, rows.size), (rows, cols)), shape=(N, N)
    )
    W = W + W.T
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W
    L = (L + 0.1 * sp.eye(N)).tocsr()
    scramble = rng.permutation(N)
    return L[scramble][:, scramble].tocsr()


def main():
    A = build_graph_operator()
    N = A.shape[0]

    # --- 1. bandwidth reduction ------------------------------------------
    perm = reverse_cuthill_mckee(A, symmetric_mode=True)
    Ar = A[perm][:, perm].tocsr()
    coo, roo = Ar.tocoo(), A.tocoo()
    print("RCM: occupied diagonals "
          f"{np.unique(roo.col - roo.row).size} -> "
          f"{np.unique(coo.col - coo.row).size}")

    # --- 2. the accelerator-native sparse matvec ----------------------------------
    Amv = ops.dia_from_scipy(Ar)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(N))
    exact = np.abs(np.asarray(Amv(x)) - Ar @ np.asarray(x)).max()
    print(f"DIA matvec: {Amv.dia_data.shape[0]} diagonals, "
          f"max |DIA - scipy| = {exact:.1e}")

    # --- 3a. SPD path: block-Jacobi + CG ----------------------------------
    # (a random rhs: ones is nearly an eigenvector of a graph Laplacian)
    b = jnp.asarray(np.random.default_rng(2).standard_normal(N))
    Mbj = ops.block_jacobi_preconditioner(Amv, block_size=32)
    plain = F.cg(Amv, b, tol=1e-8, maxiter=2000)
    prec = F.cg(Amv, b, M=Mbj, tol=1e-8, maxiter=2000)
    print(f"CG iterations: {int(plain.niter)} plain -> "
          f"{int(prec.niter)} block-Jacobi")

    # --- 3b. nonsymmetric path: SPAI + GMRES -------------------------------
    Anon = (Ar - 0.7 * sp.tril(Ar, -1)).tocsr()   # break symmetry
    Amv_n = ops.dia_from_scipy(Anon)
    Mspai = ops.spai_preconditioner(Anon)
    print(f"SPAI certificate ||AM - I||_F / sqrt(N) = "
          f"{Mspai.spai_residual:.3f}")
    g0 = F.gmres(Amv_n, b, tol=1e-8, maxiter=400)
    gs = F.gmres(Amv_n, b, Mr=Mspai, tol=1e-8, maxiter=400)
    print(f"GMRES iterations: {int(g0.niter)} plain -> "
          f"{int(gs.niter)} SPAI")

    # --- 4. batched small systems -----------------------------------------
    rng = np.random.default_rng(1)
    B, n = 32, 24
    Q = np.linalg.qr(rng.standard_normal((B, n, n)))[0]
    evs = rng.uniform(1.0, 10.0, (B, n))
    As = np.einsum("bij,bj,bkj->bik", Q, evs, Q)
    bs = rng.standard_normal((B, n))
    res = jax.jit(
        jax.vmap(lambda Ai, bi: F.cg(Ai, bi, tol=1e-10, maxiter=100))
    )(jnp.asarray(As), jnp.asarray(bs))
    niter = np.asarray(res.niter)
    print(f"batched CG: {B} systems in one program, iterations "
          f"{niter.min()}..{niter.max()}, all converged: "
          f"{bool((np.asarray(res.status) == F.CONVERGED).all())}")


if __name__ == "__main__":
    main()
