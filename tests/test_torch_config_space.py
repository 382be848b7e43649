"""The port's ``ConfigSpace`` held to the reference's on the same spaces.

Each space is declared once as data and built in both packages: plain,
restricted by a callable, restricted by a string expression, both, and
empty. Enumeration order, defaults, sampling and neighbours for one seed,
the unit encoding, ``freeze``, ``config_hash`` (in this process and in
children under other ``PYTHONHASHSEED`` values) and ``shard`` must agree
config for config. The shard partition is also held exact on the port's
own Hopper spaces, which the reference does not have.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core as rc
import repro_torch.core as pc

REPO = Path(__file__).resolve().parent.parent

#: name -> (params as (name, values, default), restrictions). A string
#: restriction is passed as is; a callable one is named here and defined
#: once below, so both packages run the same function.
SPACES = {
    "plain": ([("block_x", (16, 32, 64, 128), 32), ("block_y", (1, 2, 4, 8),
                                                    None),
               ("unroll", (1, 2, 4), None), ("flag", (True, False), None)],
              []),
    "callable": ([("block_x", (16, 32, 64, 128), 32),
                  ("unroll", (1, 2, 4), 2), ("order", ("xyz", "zyx"), None)],
                 ["x_divides_unroll"]),
    "string": ([("block_x", (16, 32, 64, 128), 32), ("block_y", (1, 2, 4, 8),
                                                     None)],
               ["block_x * block_y <= 256"]),
    "both": ([("block_x", (16, 32, 64, 128), 32), ("block_y", (1, 2, 4, 8),
                                                   None),
              ("unroll", (1, 2, 4), None), ("flag", (True, False), None)],
             ["block_x * block_y <= 512", "x_divides_unroll"]),
    "empty": ([], []),
}
CALLABLES = {"x_divides_unroll": lambda c: c["block_x"] % c["unroll"] == 0}
NAMES = sorted(SPACES)
NONEMPTY = [n for n in NAMES if SPACES[n][0]]


def build(pkg, name: str):
    params, rules = SPACES[name]
    s = pkg.ConfigSpace()
    for pname, values, default in params:
        s.tune(pname, values, default=default)
    for rule in rules:
        s.restrict(CALLABLES.get(rule, rule))
    return s


def both(name: str):
    return build(pc, name), build(rc, name)


@pytest.mark.parametrize("name", NAMES)
def test_counts_enumeration_and_default_equal(name):
    port, ref = both(name)
    assert port.cardinality() == ref.cardinality()
    assert port.valid_cardinality() == ref.valid_cardinality()
    got, want = list(port.enumerate()), list(ref.enumerate())
    assert got == want
    assert len(got) == port.valid_cardinality()
    assert all(port.is_valid(c) for c in got)
    assert port.default_config() == ref.default_config()
    assert port.is_valid(port.default_config())
    assert list(port.enumerate(limit=3)) == list(ref.enumerate(limit=3))


def _duplicate(pkg):
    s = pkg.ConfigSpace()
    s.tune("a", (1, 2))
    s.tune("a", (3,))


def _default_outside(pkg):
    pkg.ConfigSpace().tune("a", (1, 2), default=3)


def _check_invalid(pkg):
    build(pkg, "string").check({"block_x": 128, "block_y": 8})


def _check_unknown_value(pkg):
    build(pkg, "plain").check({"block_x": 5, "block_y": 1, "unroll": 1,
                               "flag": True})


@pytest.mark.parametrize("declare", [_duplicate, _default_outside,
                                     _check_invalid, _check_unknown_value],
                         ids=lambda f: f.__name__.strip("_"))
def test_refusals_raise_the_references_exception_type(declare):
    raised = []
    for pkg in (pc, rc):
        with pytest.raises(Exception) as info:
            declare(pkg)
        raised.append(type(info.value).__name__)
    assert raised[0] == raised[1]
    assert raised[0] == "ValueError"


@settings(max_examples=40, deadline=None)
@given(name=st.sampled_from(NONEMPTY), seed=st.integers(0, 2**31 - 1),
       n=st.integers(1, 8))
def test_sample_and_neighbor_equal_for_one_seed(name, seed, n):
    port, ref = both(name)
    got = port.sample(np.random.default_rng(seed), n)
    want = ref.sample(np.random.default_rng(seed), n)
    assert got == want
    assert all(port.is_valid(c) for c in got)
    rng_p, rng_r = np.random.default_rng(seed), np.random.default_rng(seed)
    for cfg in got:
        nb = port.neighbor(cfg, rng_p)
        assert nb == ref.neighbor(cfg, rng_r)
        assert port.is_valid(nb)
        assert sum(cfg[k] != nb[k] for k in cfg) <= 1


@settings(max_examples=40, deadline=None)
@given(name=st.sampled_from(NONEMPTY), seed=st.integers(0, 2**31 - 1))
def test_unit_encoding_equal_and_round_trips(name, seed):
    port, ref = both(name)
    cfg = port.sample(np.random.default_rng(seed), 1)[0]
    vec = port.to_unit(cfg)
    np.testing.assert_array_equal(vec, ref.to_unit(cfg))
    assert port.from_unit(vec) == ref.from_unit(vec) == cfg
    # a point between grid values decodes the same way in both
    jitter = np.clip(vec + np.random.default_rng(seed).uniform(
        -0.2, 0.2, vec.shape), 0.0, 1.0)
    assert port.from_unit(jitter) == ref.from_unit(jitter)


@pytest.mark.parametrize("name", NAMES)
def test_freeze_equal_and_order_free(name):
    port, ref = both(name)
    for cfg in port.enumerate():
        reordered = dict(reversed(list(cfg.items())))
        assert port.freeze(cfg) == ref.freeze(cfg) == port.freeze(reordered)
        hash(port.freeze(cfg))


@pytest.mark.parametrize("name", NAMES)
def test_config_hash_equal_per_config(name):
    port, ref = both(name)
    for cfg in port.enumerate():
        reordered = dict(reversed(list(cfg.items())))
        assert port.config_hash(cfg) == ref.config_hash(cfg)
        assert port.config_hash(reordered) == port.config_hash(cfg)


#: The child: every config's hash in each space, from the port alone (it
#: imports no JAX). argv: the port's path, then SPACES as JSON.
_HASH_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.core import ConfigSpace
callables = {"x_divides_unroll": lambda c: c["block_x"] % c["unroll"] == 0}
out = {}
for name, (params, rules) in json.loads(sys.argv[2]).items():
    s = ConfigSpace()
    for pname, values, default in params:
        s.tune(pname, tuple(values), default=default)
    for rule in rules:
        s.restrict(callables.get(rule, rule))
    out[name] = [s.config_hash(c) for c in s.enumerate()]
print(json.dumps(out))
"""


def test_config_hash_is_the_references_in_children_of_any_hash_seed():
    procs = []
    for seed in ("0", "1"):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _HASH_CHILD, str(REPO / "src"),
             json.dumps(SPACES)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    want = {n: [r.config_hash(c) for c in r.enumerate()]
            for n in NAMES for r in [build(rc, n)]}
    assert outs[0] == outs[1] == want
    # the reference's pinned literals hold for the port too
    s = pc.ConfigSpace()
    s.tune("block_x", (16, 32, 64, 128), default=32)
    s.tune("flag", (True, False))
    assert s.config_hash({"block_x": 16, "flag": True}) == 0x7375c74b6b75025f
    assert pc.ConfigSpace().config_hash({}) == 0x0caa2b8ca1cd534f


def _members(space, i, n):
    return [space.freeze(c) for c in space.shard(i, n).enumerate()]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("name", NAMES)
def test_shard_members_equal_and_partition_exact(name, n):
    port, ref = both(name)
    parts = [_members(port, i, n) for i in range(n)]
    assert parts == [_members(ref, i, n) for i in range(n)]
    flat = [c for p in parts for c in p]
    assert len(flat) == len(set(flat))
    assert sorted(flat) == sorted(port.freeze(c) for c in port.enumerate())
    # re-derived shards are identical (replanning)
    assert parts == [_members(port, i, n) for i in range(n)]
    for i in range(n):
        assert all(port.is_valid(c) for c in port.shard(i, n).enumerate())


@pytest.mark.parametrize("index,n", [(-1, 4), (4, 4), (0, 0), (0, -2)])
def test_shard_index_validation_is_the_references(index, n):
    raised = []
    for pkg in (pc, rc):
        with pytest.raises(Exception) as info:
            build(pkg, "both").shard(index, n)
        raised.append(type(info.value).__name__)
    assert raised == ["ValueError", "ValueError"]


def test_more_shards_than_configs_leaves_surplus_shards_empty():
    spaces = []
    for pkg in (pc, rc):
        s = pkg.ConfigSpace()
        s.tune("x", (0, 1, 2))
        spaces.append(s)
    n = 8
    port = [_members(spaces[0], i, n) for i in range(n)]
    assert port == [_members(spaces[1], i, n) for i in range(n)]
    flat = [c for p in port for c in p]
    assert sorted(flat) == sorted(spaces[0].freeze(c)
                                  for c in spaces[0].enumerate())
    assert len(flat) == 3 and sum(1 for p in port if not p) == n - 3


def test_empty_space_has_one_config_and_one_owner():
    for pkg in (pc, rc):
        s = pkg.ConfigSpace()
        assert s.cardinality() == 1
        assert list(s.enumerate()) == [{}]
        assert list(s.shard(0, 1).enumerate()) == [{}]
    owners = [[i for i in range(3) if list(pkg.ConfigSpace().shard(i, 3)
                                           .enumerate())]
              for pkg in (pc, rc)]
    assert owners[0] == owners[1] and len(owners[0]) == 1


@pytest.mark.parametrize("kernel", ["advec_u", "matmul",
                                    "flash_attention_causal"])
def test_shards_of_the_ports_hopper_spaces_partition_exactly(kernel):
    space = pc.get_kernel(kernel).space
    n = 4
    parts = [_members(space, i, n) for i in range(n)]
    flat = [c for p in parts for c in p]
    assert len(flat) == len(set(flat)) == space.valid_cardinality()
    assert set(flat) == {space.freeze(c) for c in space.enumerate()}
    assert all(parts), f"{kernel}: an empty shard of {n}"
