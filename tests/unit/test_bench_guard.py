"""Unit tests for the benchmark ledger hygiene logic: outlier refusal,
protocol awareness, note exemption, and the best-of-recent regression
check.  Pure Python — no JAX, no device.
"""

import json

from benchmarks.run import _check_regressions, _outlier_guard


def _write(path, rows):
    with open(path, "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")


def _row(bench="mesh", rays=10e6, quick=False, **kw):
    return dict(bench=bench, quick=quick, rays_per_s=rays, **kw)


def test_outlier_guard_refuses_far_off_record(tmp_path):
    p = str(tmp_path / "r.jsonl")
    _write(p, [_row(rays=10e6), _row(rays=11e6), _row(rays=9e6)])
    rec = _row(rays=2e6)          # 5x below the median
    assert not _outlier_guard(p, "mesh", rec, note=None)
    assert "note" not in rec
    rec = _row(rays=2e6)
    assert _outlier_guard(p, "mesh", rec, note="known slow config")
    assert rec["note"] == "known slow config"


def test_outlier_guard_accepts_in_band_and_sparse_history(tmp_path):
    p = str(tmp_path / "r.jsonl")
    _write(p, [_row(rays=10e6), _row(rays=11e6)])
    assert _outlier_guard(p, "mesh", _row(rays=9e6), note=None)
    # <2 prior records: always accept
    _write(p, [_row(rays=10e6)])
    assert _outlier_guard(p, "mesh", _row(rays=1e3), note=None)


def test_outlier_guard_is_protocol_aware(tmp_path):
    """Single-step-era inverse rows must not gate chained-dispatch rows
    (the 27.8 vs 200 steps/s case)."""
    p = str(tmp_path / "r.jsonl")
    _write(p, [dict(bench="inverse", quick=False, steps_per_s=27.8),
               dict(bench="inverse", quick=False, steps_per_s=29.2)])
    rec = dict(bench="inverse", quick=False, steps_per_s=195.0,
               steps_per_dispatch=8, chained_protocol=True)
    assert _outlier_guard(p, "inverse", rec, note=None)   # not comparable


def test_outlier_guard_exempts_quick_and_noted(tmp_path):
    p = str(tmp_path / "r.jsonl")
    _write(p, [_row(rays=10e6), _row(rays=11e6), _row(rays=9e6)])
    assert _outlier_guard(p, "mesh", _row(rays=1e6, quick=True), note=None)
    # noted rows are excluded from the prior median
    _write(p, [_row(rays=10e6), _row(rays=11e6),
               _row(rays=1e6, note="anomaly")])
    assert _outlier_guard(p, "mesh", _row(rays=9.5e6), note=None)


def test_check_best_of_recent_tolerates_one_slow_roll(tmp_path):
    """Best-of-recent protocol: a single slow record among the recent
    ones must not fail the check."""
    p = str(tmp_path / "r.jsonl")
    _write(p, [_row(rays=10e6), _row(rays=10.2e6), _row(rays=10.1e6),
               _row(rays=7.8e6),      # one slow process
               _row(rays=10.05e6)])
    assert _check_regressions(p, ["mesh"]) == 0


def test_check_flags_persistent_regression(tmp_path):
    p = str(tmp_path / "r.jsonl")
    _write(p, [_row(rays=10e6), _row(rays=10.2e6),
               _row(rays=7e6), _row(rays=7.1e6), _row(rays=6.9e6)])
    assert _check_regressions(p, ["mesh"]) == 1


def test_check_is_protocol_aware(tmp_path):
    """A chained-protocol regression must be judged against chained
    records, not the (much lower) single-step era."""
    p = str(tmp_path / "r.jsonl")
    _write(p, [dict(bench="inverse", quick=False, steps_per_s=27.8),
               dict(bench="inverse", quick=False, steps_per_s=195.0,
                    steps_per_dispatch=8, chained_protocol=True),
               dict(bench="inverse", quick=False, steps_per_s=100.0,
                    steps_per_dispatch=8, chained_protocol=True)])
    assert _check_regressions(p, ["inverse"]) == 1   # 100 < 0.9*195
    # ...whereas vs the single-step rows alone 100 would look like a win
