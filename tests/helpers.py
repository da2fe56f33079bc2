"""Shared test fixtures: the numerical-property matrix family of the
reference test-suite (test/test_utils.py:14-99) -- six 10x10 operators
spanning SPD / HPD / symmetric-indefinite / hermitian-indefinite /
nonsymmetric / complex-nonsymmetric, three inner-product forms, operator
and vector shape dualities."""

import numpy
import jax.numpy as jnp

import krypy_tpu  # noqa: F401 -- import enables x64 policy
from krypy_tpu import utils


def matrix_spd():
    a = numpy.linspace(1, 2, 10)
    a[-1] = 1e-2
    return numpy.diag(a)


def matrix_hpd():
    a = numpy.linspace(1, 2, 10).astype(complex)
    a[0] = 5
    a[-1] = 1e-1
    A = numpy.diag(a)
    A[-1, 0] = 1e-1j
    A[0, -1] = -1e-1j
    return A


def matrix_symm_indef():
    a = numpy.linspace(1, 2, 10)
    a[-1] = -1
    return numpy.diag(a)


def matrix_herm_indef():
    a = numpy.linspace(1, 2, 10).astype(complex)
    a[-1] = 1e-3
    A = numpy.diag(a)
    A[-1, 0] = 10j
    A[0, -1] = -10j
    return A


def matrix_nonsymm():
    a = numpy.arange(1, 11).astype(float)
    a[-1] = -1e1
    A = numpy.diag(a)
    A[0, -1] = 1e1
    return A


def matrix_comp_nonsymm():
    a = numpy.arange(1, 11).astype(complex)
    a[-1] = -1e1
    A = numpy.diag(a)
    A[0, -1] = 1.0e1j
    return A


def get_matrices(
    spd=True,
    hpd=True,
    symm_indef=True,
    herm_indef=True,
    nonsymm=True,
    comp_nonsymm=True,
):
    out = []
    if spd:
        out.append(matrix_spd())
    if hpd:
        out.append(matrix_hpd())
    if symm_indef:
        out.append(matrix_symm_indef())
    if herm_indef:
        out.append(matrix_herm_indef())
    if nonsymm:
        out.append(matrix_nonsymm())
    if comp_nonsymm:
        out.append(matrix_comp_nonsymm())
    return out


_B = numpy.diag(numpy.linspace(1, 5, 10))


def get_ip_Bs():
    B = _B
    return [
        None,
        utils.MatrixLinearOperator(B),
        lambda x, y: jnp.dot(x.conj().T, jnp.dot(jnp.asarray(B), y)),
    ]


def get_operators(A):
    return [A, utils.MatrixLinearOperator(A)]


def get_vecs(v):
    return [v, numpy.reshape(v, (v.shape[0],))]


def loop_body_allreduces(jitted, *args, mesh, include_branches=False):
    """All-reduce count of the compiled while-LOOP BODY: the
    steady-state per-iteration sync-point cost of a solver on a mesh.

    Robust to XLA's VARIADIC all-reduces -- ``(f32[m], f32[])
    all-reduce(%a, %b)`` fuses several reductions into ONE sync point
    and must count as one instruction (a plain ``= \\S+ all-reduce``
    regex misses the tuple result type entirely).

    Only ``body=`` computations of while loops are counted, so ENTRY
    setup/teardown reductions and ``lax.cond`` branch computations
    (e.g. rare explicit-residual verifications) do not pollute the
    steady-state number.  For solvers whose per-iteration work itself
    lives inside a ``lax.cond`` (lobpcg's active-iteration branch),
    pass ``include_branches=True``: branch computations reachable from
    a loop body are then eligible too, and the max single-computation
    count is returned.
    """
    import re as _re

    with mesh:
        txt = jitted.lower(*args).compile().as_text()
    comps = {}
    for comp in _re.split(r"\n\n", txt):
        m = _re.match(r"%([^\s(]+)", comp)
        if m:
            comps[m.group(1)] = comp
    eligible = set(_re.findall(r"body=%([^,)\s]+)", txt))
    if include_branches:
        frontier = list(eligible)
        while frontier:
            comp = comps.get(frontier.pop(), "")
            for grp in _re.findall(r"branch_computations=\{([^}]*)\}", comp):
                for name in _re.findall(r"%([^,)\s]+)", grp):
                    if name not in eligible:
                        eligible.add(name)
                        frontier.append(name)
    best = 0
    for name in eligible:
        n = len(
            _re.findall(
                r"= \S.* all-reduce\(|all-reduce-start", comps.get(name, "")
            )
        )
        best = max(best, n)
    return best


def iteration_allreduces(jitted, *args, mesh):
    """Sync points of one iteration whose orthogonalization runs in a
    ``lax.switch`` branch (GMRES's prefix buckets): per while-loop body,
    its own all-reduces plus those of its largest directly called branch
    computation; the max over loop bodies."""
    import re as _re

    with mesh:
        txt = jitted.lower(*args).compile().as_text()
    comps = {}
    for comp in _re.split(r"\n\n", txt):
        m = _re.match(r"%([^\s(]+)", comp)
        if m:
            comps[m.group(1)] = comp

    def count(name):
        return len(_re.findall(
            r"= \S.* all-reduce\(|all-reduce-start", comps.get(name, "")
        ))

    best = 0
    for body in set(_re.findall(r"body=%([^,)\s]+)", txt)):
        comp = comps.get(body, "")
        branches = [
            name
            for grp in _re.findall(r"branch_computations=\{([^}]*)\}", comp)
            for name in _re.findall(r"%([^,)\s]+)", grp)
        ]
        best = max(best, count(body) + max(map(count, branches), default=0))
    return best
