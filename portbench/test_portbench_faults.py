"""Each cell's run at a test's size on the CPU, through the runner the
benchmark drives (the look for a chip skipped): sound, it comes out
correct; with its timed path broken underneath, or with the TF32
control in the program's place, it does not."""
from __future__ import annotations

import pytest

from portbench import check, faults

SEED = 2**31 + 4242
SAMPLERS = ["hybrid.cambridge-1m", "uncollapsed.cambridge-1m"]


def _run(workload, **kw):
    ctx, runner = faults.small_ctx(workload, SEED, **kw)
    out = runner.run(ctx)
    return out, ctx.limits


@pytest.mark.parametrize("workload", ["hybrid.cambridge-1m",
                                      "uncollapsed.cambridge-1m"])
def test_sound_run_is_correct_and_control_is_not(workload):
    out, limits = _run(workload, control=True)
    ok, rows = check.held(out.numbers, limits)
    assert ok, rows
    ok, rows = check.held(out.facts["control"], limits)
    assert not ok, rows


@pytest.mark.parametrize("workload,module", [
    ("hybrid.cambridge-1m", "repro_torch.core.ibp.hybrid"),
    ("uncollapsed.cambridge-1m", "repro_torch.core.ibp.uncollapsed")])
def test_half_the_rows_left_out(workload, module):
    undo = faults.half_rows(module)
    try:
        out, limits = _run(workload)
    finally:
        undo()
    ok, rows = check.held(out.numbers, limits)
    assert not ok, rows


@pytest.mark.parametrize("workload", SAMPLERS)
@pytest.mark.parametrize("fault", [faults.unchanged_step,
                                   faults.altered_sigma])
def test_sampler_faults_fail(workload, fault):
    out, limits = _run(workload, fault=fault)
    ok, rows = check.held(out.numbers, limits)
    assert not ok, rows


def test_dropped_sweep_results_fail():
    # every sweep runs and is recorded, and the step keeps its old Z
    out, limits = _run("hybrid.cambridge-1m", fault=faults.dropped_sweeps)
    ok, rows = check.held(out.numbers, limits)
    assert not ok, rows
    assert out.numbers["stage_chain"] > 0

