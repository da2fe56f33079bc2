"""Stateful recycling drivers (reference semantics: krypy/recycling/linsys.py).

A recycling solver is constructed once and then fed a *sequence* of linear
systems via :meth:`_RecyclingSolver.solve`; between solves it extracts
deflation vectors from the previous solve through a vector factory.

Structure: the factory string shortcuts live in a module-level registry of
builders (:data:`FACTORY_SHORTCUTS`) rather than an if/elif chain, and the
two phases of a solve (subspace selection, deflated solve) are separate
methods so subclasses and profiling hooks can target them individually.
For the compile-cached production lane see
:class:`krypy_tpu.functional.deflation.RecyclingGmres`.
"""

import jax.numpy as jnp

from .. import deflation, linsys, utils
from . import evaluators, factories

__all__ = ["RecyclingCg", "RecyclingMinres", "RecyclingGmres"]


#: name -> zero-argument builder of a vector factory; resolved lazily so
#: each solve can request a fresh factory by string
FACTORY_SHORTCUTS = {
    "RitzApproxKrylov": lambda: factories.RitzFactory(
        subset_evaluator=evaluators.RitzApproxKrylov()
    ),
    "RitzAprioriCg": lambda: factories.RitzFactory(
        subset_evaluator=evaluators.RitzApriori(Bound=utils.BoundCG)
    ),
    "RitzAprioriMinres": lambda: factories.RitzFactory(
        subset_evaluator=evaluators.RitzApriori(Bound=utils.BoundMinres)
    ),
}


class _RecyclingSolver:
    """Base class for recycling solvers.

    :param DeflatedSolver: deflated solver class from
      :mod:`krypy_tpu.deflation`.
    :param vector_factory: (optional) a
      :class:`~krypy_tpu.recycling.factories._DeflationVectorFactory` that
      produces deflation vectors from the last solve, or one of the string
      shortcuts in :data:`FACTORY_SHORTCUTS`.
    """

    def __init__(self, DeflatedSolver, vector_factory=None):
        self._DeflatedSolver = DeflatedSolver
        self._vector_factory = vector_factory

        #: timings of the two phases (vector factory / solve) of each call
        self.timings = utils.Timings()

        #: deflated solver instance of the last :meth:`solve` call
        self.last_solver = None

    def _select_subspace(self, linear_system, factory_spec):
        """Phase 1: resolve the factory spec and harvest deflation vectors
        from the previous solve (an empty basis on the first call or
        without a factory)."""
        if factory_spec is None:
            factory_spec = self._vector_factory
        build = FACTORY_SHORTCUTS.get(factory_spec)
        factory = build() if build is not None else factory_spec

        if factory is None or self.last_solver is None:
            return jnp.zeros((linear_system.N, 0))
        return factory.get(self.last_solver)

    def _run_deflated(self, linear_system, U, args, kwargs):
        """Phase 2: the deflated solve, always retaining the Arnoldi data
        the next selection round needs."""
        kwargs = dict(kwargs, store_arnoldi=True)
        return self._DeflatedSolver(linear_system, U=U, *args, **kwargs)

    def solve(self, linear_system, vector_factory=None, *args, **kwargs):
        """Solve ``linear_system`` with deflation vectors recycled from the
        previous solve.

        :param vector_factory: per-call override of the factory given at
          construction.
        :returns: the deflated solver instance (solution in ``.xk``).
        """
        # the evaluators' time model needs measured per-operator timings
        if not isinstance(linear_system, linsys.TimedLinearSystem):
            linear_system = linsys.ConvertedTimedLinearSystem(linear_system)

        with self.timings["vector_factory"]:
            U = self._select_subspace(linear_system, vector_factory)
        with self.timings["solve"]:
            self.last_solver = self._run_deflated(
                linear_system, U, args, kwargs
            )
        return self.last_solver


class RecyclingCg(_RecyclingSolver):
    """Recycling preconditioned CG."""

    def __init__(self, *args, **kwargs):
        super().__init__(deflation.DeflatedCg, *args, **kwargs)


class RecyclingMinres(_RecyclingSolver):
    """Recycling preconditioned MINRES."""

    def __init__(self, *args, **kwargs):
        super().__init__(deflation.DeflatedMinres, *args, **kwargs)


class RecyclingGmres(_RecyclingSolver):
    """Recycling preconditioned GMRES."""

    def __init__(self, *args, **kwargs):
        super().__init__(deflation.DeflatedGmres, *args, **kwargs)
