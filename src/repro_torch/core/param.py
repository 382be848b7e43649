"""Tunable-parameter configuration spaces (paper §4.1).

A :class:`ConfigSpace` holds named tunable parameters with finite value sets,
plus boolean *restrictions* over the joint space — the same model Kernel
Launcher / Kernel Tuner use. Restrictions may be Python callables
``config -> bool`` or strings evaluated with the config as the namespace
(mirroring the paper's "boolean expressions").
"""

from __future__ import annotations

import hashlib
import itertools
import json
import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Sequence

import numpy as np

Config = dict[str, Any]


@dataclass(frozen=True)
class TunableParam:
    """One tunable parameter: a name, its allowed values, and a default."""

    name: str
    values: tuple
    default: Any

    def __post_init__(self):
        if len(self.values) == 0:
            raise ValueError(f"parameter {self.name!r} has no values")
        if self.default not in self.values:
            raise ValueError(
                f"default {self.default!r} for {self.name!r} not in values"
            )

    def index_of(self, value) -> int:
        return self.values.index(value)


class ConfigSpace:
    """The joint (cartesian) space of all tunable parameters + restrictions."""

    def __init__(self) -> None:
        self._params: dict[str, TunableParam] = {}
        self._restrictions: list[Callable[[Config], bool]] = []
        self._restriction_srcs: list[str] = []

    # -- construction -------------------------------------------------------

    def tune(self, name: str, values: Sequence, default=None) -> TunableParam:
        """Declare a tunable parameter (paper Listing 3, ``builder.tune``)."""
        if name in self._params:
            raise ValueError(f"duplicate tunable parameter {name!r}")
        values = tuple(values)
        if default is None:
            default = values[0]
        p = TunableParam(name, values, default)
        self._params[name] = p
        return p

    def restrict(self, expr: str | Callable[[Config], bool]) -> None:
        """Add a search-space restriction (boolean expression or callable)."""
        if callable(expr):
            self._restrictions.append(expr)
            self._restriction_srcs.append(getattr(expr, "__name__", "<fn>"))
        else:
            code = compile(expr, "<restriction>", "eval")

            def _check(config: Config, _code=code) -> bool:
                return bool(eval(_code, {"__builtins__": {}, "min": min,
                                         "max": max, "abs": abs}, dict(config)))

            self._restrictions.append(_check)
            self._restriction_srcs.append(expr)

    # -- introspection ------------------------------------------------------

    @property
    def params(self) -> dict[str, TunableParam]:
        return dict(self._params)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self._params)

    def default_config(self) -> Config:
        return {p.name: p.default for p in self._params.values()}

    def cardinality(self) -> int:
        """Size of the unrestricted cartesian space."""
        return math.prod(len(p.values) for p in self._params.values())

    def is_valid(self, config: Config) -> bool:
        for name, p in self._params.items():
            if name not in config or config[name] not in p.values:
                return False
        return all(r(config) for r in self._restrictions)

    def check(self, config: Config) -> None:
        if not self.is_valid(config):
            raise ValueError(f"invalid config for space: {config}")

    # -- iteration / sampling ----------------------------------------------

    def enumerate(self, limit: int | None = None) -> Iterator[Config]:
        """Yield valid configs in lexicographic order (optionally capped)."""
        names = list(self._params)
        count = 0
        for combo in itertools.product(
            *(p.values for p in self._params.values())
        ):
            cfg = dict(zip(names, combo))
            if all(r(cfg) for r in self._restrictions):
                yield cfg
                count += 1
                if limit is not None and count >= limit:
                    return

    def valid_cardinality(self, cap: int = 1_000_000) -> int:
        n = 0
        for _ in self.enumerate(limit=cap):
            n += 1
        return n

    def sample(self, rng: np.random.Generator, n: int = 1,
               max_tries: int = 10_000) -> list[Config]:
        """Rejection-sample ``n`` valid configs."""
        out: list[Config] = []
        tries = 0
        names = list(self._params)
        while len(out) < n and tries < max_tries * n:
            cfg = {
                name: p.values[int(rng.integers(len(p.values)))]
                for name, p in self._params.items()
            }
            tries += 1
            if all(r(cfg) for r in self._restrictions):
                out.append(cfg)
        if len(out) < n:
            raise RuntimeError(
                f"could not sample {n} valid configs in {tries} tries "
                f"({len(names)} params)"
            )
        return out

    def neighbor(self, config: Config, rng: np.random.Generator,
                 max_tries: int = 200) -> Config:
        """Random single-parameter mutation (for local-search strategies)."""
        names = list(self._params)
        for _ in range(max_tries):
            cfg = dict(config)
            name = names[int(rng.integers(len(names)))]
            p = self._params[name]
            if len(p.values) == 1:
                continue
            cur = p.index_of(cfg[name])
            # move to an adjacent value preferentially, else any other value
            if rng.random() < 0.7:
                step = -1 if rng.random() < 0.5 else 1
                idx = min(max(cur + step, 0), len(p.values) - 1)
            else:
                idx = int(rng.integers(len(p.values)))
            if idx == cur:
                continue
            cfg[name] = p.values[idx]
            if all(r(cfg) for r in self._restrictions):
                return cfg
        return dict(config)

    # -- numeric encoding (for model-based strategies) ----------------------

    def to_unit(self, config: Config) -> np.ndarray:
        """Encode a config as a point in [0,1]^d (value-index scaled)."""
        vec = np.zeros(len(self._params), dtype=np.float64)
        for i, (name, p) in enumerate(self._params.items()):
            hi = max(len(p.values) - 1, 1)
            vec[i] = p.index_of(config[name]) / hi
        return vec

    def from_unit(self, vec: np.ndarray) -> Config:
        cfg: Config = {}
        for i, (name, p) in enumerate(self._params.items()):
            hi = max(len(p.values) - 1, 1)
            idx = int(round(float(np.clip(vec[i], 0.0, 1.0)) * hi))
            cfg[name] = p.values[idx]
        return cfg

    def freeze(self, config: Config) -> tuple:
        """Hashable canonical form of a config."""
        return tuple((k, config[k]) for k in self._params)

    # -- sharding (fleet job partitioning) -----------------------------------

    def config_hash(self, config: Config) -> int:
        """Stable 64-bit hash of a config's canonical JSON form.

        ``hash()`` is process-randomized; shard membership must agree
        between the coordinator that planned a job and every worker that
        claims one of its shards, across processes, hosts and runs.
        """
        body = json.dumps([[k, config[k]] for k in self._params],
                          default=str)
        return int.from_bytes(hashlib.sha256(body.encode()).digest()[:8],
                              "little")

    def shard(self, index: int, n_shards: int) -> "ConfigSpace":
        """Deterministic partition member ``index`` of ``n_shards``.

        Returns a new space with the same parameters and restrictions plus
        a membership restriction: a config belongs to exactly one shard
        (``config_hash % n_shards``), so the shards are disjoint and their
        union is exactly this space's valid set. Workers tuning different
        shards of one job therefore never duplicate an evaluation, and
        re-planning the same job yields byte-identical shards.
        """
        if not 0 <= index < n_shards:
            raise ValueError(f"shard index {index} not in [0, {n_shards})")
        sub = ConfigSpace()
        for p in self._params.values():
            sub.tune(p.name, p.values, p.default)
        for fn, src in zip(self._restrictions, self._restriction_srcs):
            sub._restrictions.append(fn)
            sub._restriction_srcs.append(src)
        if n_shards > 1:
            def _member(config: Config) -> bool:
                return self.config_hash(config) % n_shards == index
            sub._restrictions.append(_member)
            sub._restriction_srcs.append(f"shard {index}/{n_shards}")
        return sub

    def __repr__(self) -> str:  # pragma: no cover
        return (f"ConfigSpace({list(self._params)}, "
                f"|space|={self.cardinality()}, "
                f"restrictions={self._restriction_srcs})")
