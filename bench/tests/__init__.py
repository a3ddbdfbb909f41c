"""CPU tests of the benchmark (``python -m pytest -q bench/tests``); the
ones marked ``cuda`` run only on the card."""
