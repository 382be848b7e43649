"""The port's ``CorrectnessOracle`` gives the reference's verdicts on the
same probes.

A kernel whose honest computation is the identity and whose built variant
adds a constant ``delta`` everywhere is the smallest numerics fault, so
the accept/reject boundary is exactly the oracle's elementwise tolerance.
It is built in both packages (CPU tensors in the port, numpy arrays in
the reference) and checked on the same hypothesis-drawn probe with
``|x| <= 1``, so the reference scale is 1 and an element may deviate by
``atol + rtol * |x|``. Both oracles must accept the exact result and
perturbations inside the tolerance, reject perturbations above it as
``numerics-mismatch``, and report the same error and tolerances.
"""

from __future__ import annotations

import numpy as np
import torch
from hypothesis import given, settings, strategies as st

import repro.core as rc
from repro.sandbox import CorrectnessOracle as RefOracle
from repro.tuner.runner import _tolerances as ref_tolerances

import repro_torch.core as pc
from repro_torch.sandbox import CorrectnessOracle
from repro_torch.tuner.runner import _tolerances

DTYPES = ["float32", "float16", "bfloat16"]


def _identity_plus(pkg, delta: float):
    """``pkg``'s builder of the perturbed identity."""
    b = pkg.KernelBuilder("oracle_props_identity", source="tests")
    b.tune("unit", (1,), default=1)

    @b.problem_size
    def _problem(x):
        return tuple(int(d) for d in x.shape)

    if pkg is pc:
        @b.build
        def _build(config, problem, meta):
            return lambda x: x.to(torch.float64) + delta

        b.reference(lambda x: x)
    else:
        @b.build
        def _build(config, problem, meta, interpret=False):
            return lambda x: np.asarray(x, np.float64) + delta

        b.reference(lambda x: np.asarray(x))
    return b


def _probe(data) -> np.ndarray:
    shape = tuple(data.draw(st.lists(st.integers(1, 8), min_size=1,
                                     max_size=3)))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31 - 1)))
    return rng.uniform(-1.0, 1.0, shape)


def verdicts(delta: float, x: np.ndarray, dtype: str):
    """(port's verdict, reference's) on the same probe, cast to ``dtype``
    once: the port's tensor holds the reference's array's bits."""
    arr = x.astype(dtype)
    port = CorrectnessOracle(_identity_plus(pc, delta),
                             [pc.to_torch(arr, dtype)]).check({"unit": 1})
    ref = RefOracle(_identity_plus(rc, delta), [arr]).check({"unit": 1})
    assert (port.status, port.ok) == (ref.status, ref.ok)
    assert (port.rtol, port.atol) == (ref.rtol, ref.atol)
    assert port.max_err == ref.max_err
    return port


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_the_exact_result_is_accepted_in_both(data):
    dtype = data.draw(st.sampled_from(DTYPES))
    v = verdicts(0.0, _probe(data), dtype)
    assert v.ok, v.detail
    assert v.max_err == 0.0
    assert (v.rtol, v.atol) == _tolerances(dtype)


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_a_perturbation_inside_the_tolerance_is_accepted_in_both(data):
    dtype = data.draw(st.sampled_from(DTYPES))
    _, atol = _tolerances(dtype)
    delta = atol * data.draw(st.floats(0.0, 0.5))
    v = verdicts(delta, _probe(data), dtype)
    assert v.ok, v.detail
    assert v.max_err <= delta + 1e-12


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_a_perturbation_above_the_tolerance_is_rejected_in_both(data):
    dtype = data.draw(st.sampled_from(DTYPES))
    rtol, atol = _tolerances(dtype)
    delta = (atol + rtol) * data.draw(st.floats(1.5, 100.0))
    v = verdicts(delta, _probe(data), dtype)
    assert v.status == "numerics-mismatch", v.status
    assert v.max_err is not None and v.max_err > atol
    assert "allclose" in v.detail


def test_tolerances_are_the_references_per_dtype():
    for dtype in [*DTYPES, "float64", "int32"]:
        assert _tolerances(dtype) == ref_tolerances(dtype)
    # one error between float32's tolerance and the half types': accepted
    # for the half types, rejected for float32, in both packages
    x = np.random.default_rng(0).uniform(-1.0, 1.0, (8, 8))
    assert verdicts(2e-3, x, "float16").ok
    assert verdicts(2e-3, x, "bfloat16").ok
    assert verdicts(2e-3, x, "float32").status == "numerics-mismatch"
