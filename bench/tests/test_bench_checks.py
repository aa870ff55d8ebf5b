"""The check that decides ``correct``, driven through whole runs on the CPU
at tiny sizes: the program passes it; the control (the reference in
bfloat16 in the program's place) and each planted fault fail it.  The
look for a card is skipped: ``run_cell`` is what ``bench/run.py`` runs
after it."""
import time

import pytest

from bench.faults import FAULTS, planted
from bench.run import run_cell
from bench.spec import Spec

CELLS = ("higgs.train", "covertype.train", "higgs.predict")
SEED = 2 ** 31 + 977


def _run(bench_dir, cell, control=None, seconds=0.5):
    spec = Spec(bench_dir)
    result, checks, _ = run_cell(spec, cell, SEED, seconds, False, ["cpu"],
                                 time.perf_counter(), control=control)
    return result, {n: (v, lim) for n, v, lim in checks}


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(tiny_bench, cell):
    result, checks = _run(tiny_bench, cell)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_bench, cell):
    result, checks = _run(tiny_bench, cell, control="bf16")
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny_bench, cell, fault):
    spec = Spec(tiny_bench)
    kind = spec.kind(spec.traffic(spec.cell(cell)["traffic"])["kind"])
    with planted(fault, kind):
        result, checks = _run(tiny_bench, cell)
    assert not result["correct"], (fault, checks)
