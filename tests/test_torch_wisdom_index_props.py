"""The port's indexed ``Wisdom.select_record`` against two linear scans of
the §4.5 selection: the port's ``select_record_linear`` and the
reference's (``repro.core.Wisdom.select_record_linear``), on the same
record sets.

Hypothesis draws record sets with measured and transferred records,
duplicate scenarios (a ``keep_best=False`` bulk load, so the list really
holds collisions), equal-score and equal-distance ties and borderline
transfer confidences; each record is built once per package from the same
fields (a transferred record's provenance is one dict, so both packages
give it one ``record_id``), and every query must give one (record_id,
tier) on all three paths. A second property interleaves ``add()`` calls
(the index kept up incrementally) with the queries.
"""

from __future__ import annotations

from hypothesis import given, settings, strategies as st

import repro.core as rc
import repro_torch.core as pc
from repro_torch.core.device import get_device
from repro_torch.core.wisdom import make_transfer_provenance

#: Device kinds of one family name in both packages.
DEVICES = ("tpu-v5e", "tpu-v4", "cpu", "tpu-v5-lite", "gpu-a100")
DTYPES = ("float32", "bfloat16")
# Small pools on purpose: ties (same scenario, score and distance) must be
# common, since the tie-break is where two implementations would differ.
DIMS = (8, 16, 64)
SCORES = (1.0, 2.0, 2.0, 7.5)
CONFIDENCES = (0.0, 0.29, 0.30, 0.31, 0.9)


def _fields_measured(t):
    kind, dtype, m, n, score, block = t
    return (kind, get_device(kind).family, (m, n), dtype, {"block": block},
            score, {"strategy": "test", "evaluations": block})


def _fields_transferred(t):
    kind, dtype, m, n, score, conf = t
    return (kind, get_device(kind).family, (m, n), dtype,
            {"transferred": True}, score,
            make_transfer_provenance("tpu-v5e", 32, conf, score))


measured_st = st.tuples(
    st.sampled_from(DEVICES), st.sampled_from(DTYPES),
    st.sampled_from(DIMS), st.sampled_from(DIMS),
    st.sampled_from(SCORES), st.integers(1, 3)).map(_fields_measured)

transferred_st = st.tuples(
    st.sampled_from(DEVICES), st.sampled_from(DTYPES),
    st.sampled_from(DIMS), st.sampled_from(DIMS),
    st.sampled_from(SCORES),
    st.sampled_from(CONFIDENCES)).map(_fields_transferred)

fields_st = st.lists(st.one_of(measured_st, transferred_st),
                     min_size=0, max_size=24)

query_st = st.tuples(
    st.sampled_from(DEVICES),
    st.tuples(st.sampled_from(DIMS + (32,)), st.sampled_from(DIMS)),
    st.sampled_from(DTYPES + ("float16",)),
    st.sampled_from((None, 0.0, 0.30, 0.5)))


def _records(pkg, fields):
    return [pkg.WisdomRecord(*f[:6], dict(f[6])) for f in fields]


def _key(result):
    rec, tier = result
    return (rec.record_id() if rec is not None else None, tier)


def assert_three_agree(port: pc.Wisdom, ref: rc.Wisdom, query) -> None:
    kind, problem, dtype, threshold = query
    got = _key(port.select_record(kind, problem, dtype, threshold))
    linear = _key(port.select_record_linear(kind, problem, dtype,
                                            threshold))
    want = _key(ref.select_record_linear(kind, problem, dtype, threshold))
    assert got == linear == want, (
        f"indexed {got} / port linear {linear} / reference linear {want} "
        f"for {query} over {len(port)} records")


@settings(max_examples=200, deadline=None)
@given(fields=fields_st, queries=st.lists(query_st, min_size=1,
                                          max_size=8))
def test_indexed_select_equals_both_linear_scans(fields, queries):
    port = pc.Wisdom("k", _records(pc, fields))
    ref = rc.Wisdom("k", _records(rc, fields))
    assert [r.record_id() for r in port.records] == \
        [r.record_id() for r in ref.records]
    for q in queries:
        assert_three_agree(port, ref, q)


@settings(max_examples=100, deadline=None)
@given(fields=fields_st, keep_best=st.lists(st.booleans(), min_size=0,
                                            max_size=24),
       queries=st.lists(query_st, min_size=1, max_size=4))
def test_the_three_agree_through_interleaved_adds(fields, keep_best,
                                                  queries):
    """add() keeps the index up incrementally (keep-best replacement,
    plain appends); the linear scans read the raw list. Each add goes to
    both packages with the same ``keep_best``."""
    port, ref = pc.Wisdom("k"), rc.Wisdom("k")
    for i, (p, r) in enumerate(zip(_records(pc, fields),
                                   _records(rc, fields))):
        kb = keep_best[i] if i < len(keep_best) else True
        port.add(p, keep_best=kb)
        ref.add(r, keep_best=kb)
        assert_three_agree(port, ref, queries[i % len(queries)])
    for q in queries:
        assert_three_agree(port, ref, q)


def test_tie_break_is_the_least_record_id_on_every_path():
    """Two same-scenario same-score records (distinct configs, so distinct
    record ids) resolve to the one with the least id, in either insertion
    order, on all three paths."""
    fields = [("tpu-v5e", "tpu-v5", (64, 64), "float32", {"block": b}, 2.0,
               {"strategy": s}) for b, s in ((1, "a"), (2, "b"))]
    for order in (fields, fields[::-1]):
        port = pc.Wisdom("k", _records(pc, order))
        ref = rc.Wisdom("k", _records(rc, order))
        q = ("tpu-v5e", (64, 64), "float32", None)
        assert_three_agree(port, ref, q)
        rec, tier = port.select_record(*q)
        assert tier == "exact" and rec.record_id() == min(
            r.record_id() for r in port.records)
