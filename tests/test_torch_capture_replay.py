"""Capture (paper §4.2) and replay tuning (§4.3) in the port, held to the
reference on the same fields.

The same seeded fields go through both packages' ``WisdomKernel``; the
capture switch, the capture each launch writes and what the reference
reads back from the port's capture must agree. Then the paper's whole
loop runs in the port on the CPU: capture, ``tune_capture`` by the cost
model on ``gpu-h100`` (each config checked once on the captured tensors
against the plain version), ``invalidate()``, and a relaunch that selects
the tuned config at tier ``exact``. The budget is a number of
evaluations, never a time, so the counts are exact under any load.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core as rc

import repro_torch.core as pc
from repro_torch.tuner import CostModelEvaluator, tune_capture

torch.set_num_threads(1)

#: The problem the ``small_fields`` fixture gives advec_u: (nz, ny, nx).
PROBLEM = (32, 32, 128)


def port_fields(small_fields):
    u, v, w, _, scal = small_fields
    return [torch.from_numpy(a.copy()) for a in (u, v, w, scal)]


@pytest.mark.parametrize("value,asked", [
    (None, ()), ("advec_u,matmul", ("advec_u", "matmul")),
    ("*", ("advec_u", "matmul", "diff_uvw", "anything")), ("", ()),
    (" advec_u ", ("advec_u",))])
def test_capture_switch_is_the_references(monkeypatch, value, asked):
    assert pc.CAPTURE_ENV == rc.CAPTURE_ENV
    if value is None:
        monkeypatch.delenv(pc.CAPTURE_ENV, raising=False)
    else:
        monkeypatch.setenv(pc.CAPTURE_ENV, value)
    for name in ("advec_u", "matmul", "diff_uvw", "anything"):
        got = pc.capture_requested(name)
        assert got == rc.capture_requested(name)
        assert got == (name in asked)


def test_a_launch_writes_the_references_capture(monkeypatch, tmp_path,
                                                small_fields):
    """One launch in each package, each into its own capture directory:
    one file each, of the same name, and the port's file reads in the
    reference as the same scenario with the same bytes."""
    monkeypatch.setenv(pc.CAPTURE_ENV, "advec_u")
    u, v, w, _, scal = small_fields
    caps = {}
    for label in ("port", "ref"):
        d = tmp_path / label / "captures"
        monkeypatch.setenv("KERNEL_LAUNCHER_CAPTURE_DIR", str(d))
        if label == "port":
            k = pc.WisdomKernel(pc.get_kernel("advec_u"),
                                wisdom_dir=tmp_path / label / "wisdom",
                                device_kind="gpu-h100")
            k(*port_fields(small_fields))
            caps[label] = pc.list_captures(d)
        else:
            k = rc.WisdomKernel(rc.get_kernel("advec_u"),
                                wisdom_dir=tmp_path / label / "wisdom",
                                device_kind="tpu-v5e", backend="reference")
            k(u, v, w, scal)
            caps[label] = rc.list_captures(d)
        assert k.stats[-1].tier == "default"
    assert len(caps["port"]) == len(caps["ref"]) == 1
    assert caps["port"][0].name == caps["ref"][0].name
    assert "advec_u-32x32x128-float32" in caps["port"][0].name
    mine = rc.load_capture(caps["port"][0])
    theirs = rc.load_capture(caps["ref"][0])
    assert (mine.kernel_name, mine.problem_size, mine.dtype) == \
        (theirs.kernel_name, theirs.problem_size, theirs.dtype)
    assert [a.tobytes() for a in mine.args] == \
        [a.tobytes() for a in theirs.args]
    assert mine.nbytes == theirs.nbytes


def _capture(monkeypatch, capture_dir, wisdom_dir, fields):
    """Launch advec_u once with capture on; the kernel and its capture."""
    monkeypatch.setenv(pc.CAPTURE_ENV, "advec_u")
    k = pc.WisdomKernel(pc.get_kernel("advec_u"), wisdom_dir=wisdom_dir,
                        device_kind="gpu-h100")
    k(*fields)
    monkeypatch.delenv(pc.CAPTURE_ENV)
    assert k.stats[-1].tier == "default"
    caps = pc.list_captures(capture_dir)
    assert len(caps) == 1
    return k, pc.load_capture(caps[0])


def test_capture_tune_relaunch_at_tier_exact(monkeypatch, capture_dir,
                                             wisdom_dir, small_fields):
    """The paper's loop: capture -> replay-tune -> wisdom -> the relaunch
    selects the tuned config, whose output is the plain version's."""
    fields = port_fields(small_fields)
    k, cap = _capture(monkeypatch, capture_dir, wisdom_dir, fields)
    assert (cap.problem_size, cap.dtype) == (PROBLEM, "float32")
    res = tune_capture(cap, "gpu-h100", strategy="random", max_evals=24,
                       time_budget_s=None, objective="costmodel",
                       wisdom_dir=wisdom_dir, device="cpu")
    assert len(res.evaluations) == 24
    feasible = res.feasible_evaluations
    assert feasible and all(np.isfinite(e.score_us) for e in feasible)
    assert res.best_score_us == min(e.score_us for e in feasible)
    rec = pc.Wisdom.load("advec_u", wisdom_dir).records[0]
    assert rec.provenance["objective"] == "costmodel"
    assert rec.config == res.best_config and rec.device_kind == "gpu-h100"
    k.invalidate()
    out = k(*fields)
    assert k.stats[-1].tier == "exact"
    assert k.stats[-1].config == res.best_config
    want = pc.get_kernel("advec_u").make_reference()(*fields)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_tuned_config_is_no_worse_than_the_default(monkeypatch, capture_dir,
                                                   wisdom_dir, small_fields):
    b = pc.get_kernel("advec_u")
    ev = CostModelEvaluator(b, PROBLEM, "float32", pc.get_device("gpu-h100"),
                            verify="none")
    default_us = ev(b.default_config()).score_us
    _, cap = _capture(monkeypatch, capture_dir, wisdom_dir,
                      port_fields(small_fields))
    res = tune_capture(cap, "gpu-h100", strategy="bayes", max_evals=30,
                       time_budget_s=None, objective="costmodel",
                       wisdom_dir=wisdom_dir, device="cpu")
    assert len(res.evaluations) == 30
    assert res.best_score_us <= default_us
    # the session's scores are the evaluator's, config for config
    for e in res.feasible_evaluations[:5]:
        assert e.score_us == ev(e.config).score_us
