"""The card's cases: ``python -m pytest -m gpu klbench/tests`` on a
machine with an H100. Each skips without a CUDA device."""

import pytest

from klbench import control, harness

ROOT = harness.KLBENCH.parent
SEED = 3_000_777_001

pytestmark = pytest.mark.gpu


def card_run(cell, cuda, seconds=1.0, trace=False):
    return harness.make_run(ROOT, cell, SEED, seconds, trace, cuda, 0.0)


def test_a_traced_grid256_run_reads_every_metric(cuda):
    run = card_run("microhh-f32.grid256", cuda, trace=True)
    readers = harness.metric_readers(harness.benchmark(ROOT), run.cell)
    res = harness.execute(run, readers)
    assert res["correct"] is True
    assert set(res["metrics"]) == set(readers)
    for name, m in res["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] <= 105, (name, m)
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]


@pytest.mark.parametrize("cell", ["microhh-f32.grid256",
                                  "codeqwen1.5-7b.prefill-mix",
                                  "codeqwen1.5-7b.train"])
def test_the_control_comes_out_not_correct(cell, cuda):
    """The reference one precision below the configuration's, put in the
    program's place at the cell's own size, fails a limit."""
    run = card_run(cell, cuda)
    loop, _ = harness.measure(run, {})
    checks = control.control_checks(loop, run)["control"]
    assert not all(c.ok for c in checks), checks
