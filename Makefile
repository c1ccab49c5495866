# Build tooling (reference parity: the upstream root Makefile that built the
# C solver and ran tests — SURVEY.md §2 "Build tooling").

.PHONY: all lib test test-all test-gpu smoke docs clean

all: lib

lib:
	$(MAKE) -C csrc

test: lib
	JAX_PLATFORMS=cpu python -m pytest tests/ -q -m "not slowtest"

# includes slow integration fits (parameter recovery / W1 parity)
test-all: lib
	JAX_PLATFORMS=cpu python -m pytest tests/ -q

# on a machine with an NVIDIA GPU: the tests marked gpu (they skip on CPU)
test-gpu: lib
	TCGAN_TEST_PLATFORM=gpu python -m pytest tests/ -q -m gpu

# on a machine with an NVIDIA GPU: the main path end to end, one card
smoke: lib
	python chip_smoke.py

# regenerate docs/cli_reference.md from the live argparse parsers
docs:
	python -m tcgan_tpu.utils.cli_docs

clean:
	$(MAKE) -C csrc clean
	rm -rf .pytest_cache tcgan_tpu/**/__pycache__ tests/__pycache__
