.PHONY: test test-par test-full bench suite smoke lint docs

docs:
	python tools/docgen.py
	python example.py

test:
	python -m pytest tests/ -q

# process-sharded run (pytest-xdist, module granularity): wall scales
# with cores, and each worker sees ~1/N of the compiled executables --
# the structural fix for XLA:CPU's compile-accumulation segfault.
test-par:
	python -m pytest tests/ -q -n auto --dist loadscope

test-full:
	KRYPY_TPU_TEST_STRIDE=1 python -m pytest tests/ -q -n auto --dist loadscope

# the main path once on one GPU, checked against host float64
smoke:
	python chip_smoke.py

bench:
	python bench.py

suite:
	python benchmarks/suite.py

lint:
	python -m compileall -q krypy_tpu tests benchmarks examples
	python tools/lint.py
