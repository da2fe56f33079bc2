"""Start-up shared by the benchmark scripts: puts the repository root on
``sys.path`` (so ``python benchmarks/<script>.py`` imports the package
from the checkout) and turns on the persistent compile cache
(:func:`krypy_tpu.config.use_compile_cache`)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from krypy_tpu.config import use_compile_cache  # noqa: E402

CACHE_DIR = use_compile_cache()
