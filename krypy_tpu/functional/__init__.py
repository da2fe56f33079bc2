"""Compile-once solver cores.

This is the production lane of krypy_tpu: each solver is a pure function
whose whole iteration -- matvec, orthogonalization, Givens QR update,
convergence check -- lives inside a single ``jax.lax.while_loop``, so a
solve is ONE XLA dispatch regardless of iteration count.  Fixed-shape
buffers (sized by ``maxiter``) keep all shapes static; breakdown/invariance
and non-convergence are reported as status codes in the returned
:class:`~krypy_tpu.functional.common.SolveResult` instead of exceptions.

All N-dimensional state shards transparently over a ``jax.sharding.Mesh``:
pass sharded operands (or wrap the call in ``jit`` with sharding
annotations) and GSPMD turns every inner product into a local partial
contraction plus an all-reduce.  See :mod:`krypy_tpu.parallel`.
"""

from .common import (
    CONVERGED,
    BREAKDOWN,
    MAXITER,
    SolveResult,
    as_matvec,
    make_inner,
)
from .arnoldi import ArnoldiResult, arnoldi
from .cg import cg
from .minres import minres
from .gmres import gmres, restarted_gmres
from .deflation import (
    AutoRecyclingGmres,
    RecyclingGmres,
    assemble_ritz_vectors,
    deflated_cg,
    deflated_gmres,
    deflated_minres,
    ritz_deflation_vectors,
    ritz_pairs,
    weighted_qr,
)
from .refine import refine_to
from .sstep import (
    ca_cg,
    ca_gmres,
    modified_leja,
    newton_shifts,
    restarted_ca_gmres,
)
from .block import block_cg, block_gmres
from .chebyshev import chebyshev, spectral_bounds
from .fgmres import fgmres
from .bicgstab import bicgstab
from .idr import idrs
from .sketch import (
    KronSketch,
    SketchedSolveResult,
    kron_sketch,
    restarted_sketched_gmres,
    sketch_apply,
    sketched_eigs,
    sketched_gmres,
)
from .randomized import RsvdResult, hutchpp, nystrom_preconditioner, rsvd
from .tfqmr import tfqmr
from .qmr import qmr, transpose_matvec
from .lsq import lsmr, lsqr
from .eigh import EigshResult, eigsh
from .eigs import EigsResult, eigs
from .filtered import (
    WindowResult,
    eigsh_window,
    estimate_spectrum_bounds,
    jackson_cheby_coeffs,
    kpm_dos,
    window_count,
)
from .lobpcg import LobpcgResult, lobpcg
from .svd import SvdsResult, svds
from .newton import NewtonResult, newton_krylov
from .funm import (
    expm_multiply,
    funm_krylov,
    funm_krylov_arnoldi,
    inv_sqrt_multiply,
    slq_logdet,
    slq_trace,
)
from .shifted import (
    ShiftedResult,
    restarted_shifted_gmres,
    shifted_cg,
    shifted_gmres,
)

__all__ = [
    "refine_to",
    "ca_cg",
    "ca_gmres",
    "modified_leja",
    "newton_shifts",
    "restarted_ca_gmres",
    "block_cg",
    "block_gmres",
    "chebyshev",
    "fgmres",
    "bicgstab",
    "idrs",
    "KronSketch",
    "SketchedSolveResult",
    "kron_sketch",
    "sketch_apply",
    "sketched_gmres",
    "restarted_sketched_gmres",
    "sketched_eigs",
    "RsvdResult",
    "rsvd",
    "nystrom_preconditioner",
    "hutchpp",
    "tfqmr",
    "qmr",
    "transpose_matvec",
    "lsqr",
    "lsmr",
    "eigsh",
    "EigshResult",
    "eigs",
    "EigsResult",
    "eigsh_window",
    "WindowResult",
    "estimate_spectrum_bounds",
    "jackson_cheby_coeffs",
    "kpm_dos",
    "window_count",
    "lobpcg",
    "LobpcgResult",
    "svds",
    "SvdsResult",
    "newton_krylov",
    "NewtonResult",
    "funm_krylov",
    "funm_krylov_arnoldi",
    "expm_multiply",
    "inv_sqrt_multiply",
    "slq_trace",
    "slq_logdet",
    "shifted_gmres",
    "restarted_shifted_gmres",
    "shifted_cg",
    "ShiftedResult",
    "spectral_bounds",
    "arnoldi",
    "ArnoldiResult",
    "cg",
    "minres",
    "gmres",
    "restarted_gmres",
    "deflated_gmres",
    "deflated_cg",
    "deflated_minres",
    "RecyclingGmres",
    "AutoRecyclingGmres",
    "ritz_deflation_vectors",
    "ritz_pairs",
    "assemble_ritz_vectors",
    "weighted_qr",
    "SolveResult",
    "CONVERGED",
    "MAXITER",
    "BREAKDOWN",
    "as_matvec",
    "make_inner",
]
