"""Analytical cost model — a kernel time from a workload, with no launch.

Port of ``repro.tuner.costmodel``, term for term. The model prices one
kernel launch described by a :class:`~repro_torch.core.workload.Workload`
on a :class:`~repro_torch.core.device.DeviceSpec`:

  t_compute    = flops / (peak · mxu_eff · ilp_eff)
  t_memory     = hbm_bytes · reuse / (bw · stream_eff)
  t            = max(t_compute, t_memory)        (double-buffered overlap)
                 or t_compute + t_memory          (buffers == 1)
  t           += grid · program_overhead          (per-program fixed cost)
  infeasible if the per-program working set exceeds spill_grace × the
  device's ``vmem_bytes`` (a block's shared memory on the H100).

Efficiencies: matmul-unit tiles pad to ``DeviceSpec.matmul_granule``
(16 on the H100's tensor cores); vector work runs at the peak over
``vector_ratio`` with lane/sublane alignment; unrolling buys
instruction-level parallelism up to ``pipeline_depth``; streaming
efficiency grows with the contiguous extent of each transfer up to 512 B.

A deterministic, config-hashed multiplicative noise term (σ ≈ 5 %) makes
the landscape rugged but reproducible; for the same workload, device kind,
dtype and key it gives the reference's number bit for bit.

In the port the model is the screening objective of the online tuner
(``repro_torch.online``) and the offline ``objective="costmodel"``: it
ranks candidates before any of them is launched, and the card's CUDA-event
times decide. Its inputs on the H100 are the kernels' workload hooks: the
stencils' ``reuse`` is their launch plan's staged-to-computed ratio, matmul
and flash attention give their tiles (``kernels/*.py``).

:class:`FittedCostModel` is the data-driven surrogate: a ridge regression
fitted (:func:`fit_from_dataset`) on a recorded tuning space, the card's
own wall-clock recordings included (``repro_torch.tunebench``); its
predictions and fit quality are the reference's to rtol 1e-12 on the same
dataset.
"""

from __future__ import annotations

import hashlib
import math
import struct
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.device import DeviceSpec
from repro_torch.core.param import Config, ConfigSpace
from repro_torch.core.workload import Workload

INFEASIBLE = float("inf")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _align_eff(dim: int, granule: int) -> float:
    if dim <= 0:
        return 1e-6
    return dim / _round_up(dim, granule)


def _hash_noise(key: str, sigma: float) -> float:
    """Deterministic lognormal-ish multiplicative noise from a string key."""
    h = hashlib.sha256(key.encode()).digest()
    # two uniform floats from the hash -> one gaussian via Box-Muller
    u1 = (struct.unpack("<Q", h[:8])[0] / 2**64) or 1e-12
    u2 = struct.unpack("<Q", h[8:16])[0] / 2**64
    z = math.sqrt(-2.0 * math.log(u1)) * math.cos(2 * math.pi * u2)
    return math.exp(sigma * z)


@dataclass(frozen=True)
class CostModel:
    """Analytical objective for one device.

    ``time(workload, dtype)`` returns modelled seconds for one launch
    (``INFEASIBLE`` when the working set blows past the spill grace),
    combining roofline compute/memory terms, alignment and ILP
    efficiencies, per-program overhead, and a deterministic config-hashed
    noise term (see the module docstring for the formulas).

    Example::

        m = CostModel(get_device("gpu-h100"), noise_sigma=0)
        t = m.time(builder.make_workload(cfg, (512,) * 3, "float32"),
                   "float32")
    """

    device: DeviceSpec
    noise_sigma: float = 0.05
    pipeline_depth: int = 4      # stages hidden by full unrolling

    def peak_flops(self, dtype: str) -> float:
        if dtype in ("bfloat16", "float16"):
            return self.device.flops_bf16
        return self.device.flops_f32

    # Up to 4x overflow of the per-program capacity degrades (the TPU
    # analogue of register spilling); beyond that the config is
    # uncompilable.
    spill_grace: float = 4.0
    spill_slope: float = 3.0

    def time(self, w: Workload, dtype: str, noise_key: str = "") -> float:
        """Modelled seconds for one launch; INFEASIBLE when the working
        set exceeds spill_grace x the device's per-program capacity."""
        if not w.valid:
            return INFEASIBLE
        overflow = w.vmem_bytes / self.device.vmem_bytes - 1.0
        if overflow > self.spill_grace - 1.0:
            return INFEASIBLE
        peak = self.peak_flops(dtype)

        # --- compute term ---
        if w.mxu_tile is not None:
            # matmul-unit tiles pad to the device's granule (128 on the
            # TPU systolic array, 16 on GPU tensor cores)
            g = self.device.matmul_granule
            m, n, k = w.mxu_tile
            eff = (_align_eff(m, g) * _align_eff(n, g)
                   * _align_eff(k, g))
            eff = max(eff, 0.02)
        else:
            # vector work: (8, 128) native tile
            eff = _align_eff(w.lane_extent, 128) * _align_eff(
                w.sublane_extent, 8)
            # the vector unit peaks below the matmul unit (per device)
            peak = peak / self.device.vector_ratio
        ilp = min(1.0, (0.55 + 0.45 * min(w.unroll_ways, self.pipeline_depth)
                        / self.pipeline_depth))
        t_compute = w.flops / (peak * eff * ilp)

        # --- memory term ---
        dtype_bytes = 2 if dtype in ("bfloat16", "float16") else 4
        contig = w.lane_extent * dtype_bytes
        stream_eff = min(1.0, contig / 512.0) ** 0.5
        stream_eff = max(stream_eff, 0.05)
        t_memory = (w.hbm_bytes * max(w.reuse, 1e-6)
                    / (self.device.hbm_bw * stream_eff))

        if w.buffers >= 2:
            t = max(t_compute, t_memory)
            # imperfect overlap: the loser still costs a fraction
            t += 0.08 * min(t_compute, t_memory)
        else:
            t = t_compute + t_memory
        t += w.grid * self.device.program_overhead
        if overflow > 0:
            t *= 1.0 + self.spill_slope * overflow

        if self.noise_sigma > 0 and noise_key:
            t *= _hash_noise(f"{self.device.kind}|{noise_key}",
                             self.noise_sigma)
        return t


def kernel_time(workload: Workload, device: DeviceSpec, dtype: str,
                noise_key: str = "") -> float:
    """One-shot convenience: modelled seconds for one launch on ``device``
    (a fresh default :class:`CostModel` each call).

    Example::

        t = kernel_time(builder.make_workload(cfg, problem, "float32"),
                        get_device("gpu-h100"), "float32")
    """
    return CostModel(device).time(workload, dtype, noise_key)


# --------------------- data-driven surrogate (tunebench) ---------------------

@dataclass
class FittedCostModel:
    """Surrogate objective fitted from a recorded tuning-space dataset.

    Ridge regression of log-score on the unit-encoded config (linear +
    quadratic terms), so prediction needs only the config — no workload
    hook, no device table. It is deliberately crude: the point is a
    *cheap, data-grounded* screen (e.g. ranking candidates before live
    trials), not replacing the recorded scores themselves. ``rmse_log``
    reports training error in log-space; compare against
    ``baseline_rmse_log`` (a constant predictor) to judge whether the
    fit learned anything.

    When fitted with ``profile_features=True`` (see
    :func:`fit_from_dataset`) the design matrix additionally carries the
    roofline counters the profiler recorded per config
    (:data:`repro_torch.prof.profile.PROFILE_FEATURES`); predictions look the
    config's counters up by its stable hash (``profile_lookup``), so the
    surrogate generalizes from *hardware structure* — a config's
    predicted compute/memory time terms — rather than raw coordinates.
    Configs the dataset never profiled contribute zero columns, which
    the centered regression treats as "no extra information".

    Example::

        model = fit_from_dataset(SpaceDataset.load("matmul.space.json"))
        ranked = sorted(space.enumerate(), key=model.predict)
    """

    space: ConfigSpace
    weights: np.ndarray
    mean_log: float
    rmse_log: float
    baseline_rmse_log: float
    n_samples: int = 0
    _dim: int = field(default=0)
    profile_lookup: dict | None = None
    n_profile_features: int = 0

    def _features(self, config: Config) -> np.ndarray:
        u = self.space.to_unit(config)
        base = np.concatenate([[1.0], u, u * u])
        if self.profile_lookup is None:
            return base
        extra = self.profile_lookup.get(
            self.space.freeze(config))
        if extra is None:
            extra = np.zeros(self.n_profile_features)
        return np.concatenate([base, extra])

    def predict(self, config: Config) -> float:
        """Predicted objective value (microseconds) for ``config``."""
        return float(math.exp(self._features(config) @ self.weights
                              + self.mean_log))

    def fit_quality(self) -> float:
        """How much structure the fit explains, in [0, 1].

        ``1 - rmse_log / baseline_rmse_log`` clamped to [0, 1]: 0 means
        the surrogate is no better than predicting the mean (it learned
        nothing), values near 1 mean the recorded landscape is almost
        fully captured. The transfer layer folds this into its
        confidence score — a prediction re-ranked through a surrogate
        that learned nothing deserves no trust.
        """
        if self.baseline_rmse_log <= 0:
            return 0.0
        return float(min(1.0, max(0.0,
                                  1.0 - self.rmse_log
                                  / self.baseline_rmse_log)))


def fit_from_dataset(dataset, ridge: float = 1e-3,
                     profile_features: bool = False) -> FittedCostModel:
    """Fit a :class:`FittedCostModel` from a recorded space.

    ``dataset`` is any object with the
    :class:`~repro_torch.tunebench.SpaceDataset` query surface (``space()`` and ``feasible()``); the fit uses every
    feasible entry. Raises ``ValueError`` with fewer than 3 feasible
    evaluations — below that a surrogate is noise.

    ``profile_features=True`` appends each entry's recorded roofline
    counters (``entry.profile``, written by the always-on profiler in
    the tuner evaluators) as extra regression columns — the
    profile-guided surrogate. Datasets recorded before the profiler
    existed fit exactly as without the flag (all-zero columns carry no
    signal), so the flag is always safe to pass.

    Example::

        ds = SpaceDataset.load("datasets/matmul--....space.json")
        model = fit_from_dataset(ds, profile_features=True)
        model.predict({"block_m": 128, ...})
    """
    feas = dataset.feasible()
    if len(feas) < 3:
        raise ValueError(
            f"need at least 3 feasible evaluations to fit, have {len(feas)}")
    space = dataset.space()
    x = np.stack([np.concatenate([[1.0], u, u * u]) for u in
                  (space.to_unit(e.config) for e in feas)])
    lookup = None
    n_prof = 0
    if profile_features:
        # Import here: repro_torch.prof depends on core only, but keeping the
        # tuner importable without it preserves layer independence.
        from repro_torch.prof.profile import (PROFILE_FEATURES,
                                        profile_feature_vector)
        n_prof = len(PROFILE_FEATURES)
        cols = np.array([profile_feature_vector(
            getattr(e, "profile", None) or {}) for e in feas])
        x = np.concatenate([x, cols], axis=1)
        lookup = {space.freeze(e.config): cols[i]
                  for i, e in enumerate(feas)}
    y = np.log(np.array([e.score_us for e in feas]))
    mean_log = float(y.mean())
    yc = y - mean_log
    # ridge: (X'X + lam I) w = X'y  (bias column unpenalized via lam on all
    # is fine at this scale)
    dim = x.shape[1]
    gram = x.T @ x + ridge * np.eye(dim)
    weights = np.linalg.solve(gram, x.T @ yc)
    resid = x @ weights - yc
    return FittedCostModel(
        space=space, weights=weights, mean_log=mean_log,
        rmse_log=float(np.sqrt(np.mean(resid**2))),
        baseline_rmse_log=float(np.sqrt(np.mean(yc**2))),
        n_samples=len(feas), _dim=dim,
        profile_lookup=lookup, n_profile_features=n_prof)
