"""Wall-clock timing instrumentation (reference: krypy/utils.py:1289-1362).

On an accelerator, per-op host timers cannot see inside a fused/jitted region, so the
timed quantities here are whole dispatches (with ``block_until_ready`` at the
caller, see :class:`~krypy_tpu.core.operators.TimedLinearOperator`).  The
``get``/``get_ops`` interface is unchanged: the recycling evaluators combine
these measurements with analytic per-solver operation counts to predict
wall-clock cost of candidate deflation subspaces.
"""

import time
from collections import defaultdict

__all__ = ["Timer", "Timings"]


class Timer(list):
    """A list of elapsed times; use as a context manager to append one."""

    def __enter__(self):
        self._tstart = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.append(time.perf_counter() - self._tstart)


class Timings(defaultdict):
    """defaultdict of :class:`Timer` keyed by operation name."""

    def __init__(self):
        super().__init__(Timer)

    def get(self, key):
        """Minimum recorded time for ``key`` (robust to noise), 0 if absent."""
        if key in self and len(self[key]) > 0:
            return min(self[key])
        return 0

    def get_ops(self, ops):
        """Dot product of a cost model ``{op: count}`` with measured times."""
        return sum(self.get(op) * count for op, count in ops.items())

    def __repr__(self):
        inner = ", ".join(f"{key}: {self.get(key)}" for key in self)
        return f"Timings({inner})"
