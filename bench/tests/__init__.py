"""CPU tests of the benchmark harness (the card's runs are bench/run.py's)."""
