"""Kernel profiler: per-launch roofline counters and bottleneck attribution.

The port of ``repro.prof``. ``repro_torch.obs`` says *that* a launch
happened; this package says *why it is fast or slow*. A
:class:`KernelProfile` joins one launch's measured latency (the CUDA-event
time ``WisdomKernel`` already takes) with the roofline counters of the
kernel's workload hook (FLOPs, compulsory HBM bytes, arithmetic intensity,
shared memory of a block) and the device's peaks, classifies the launch as
compute-, memory- or collective-bound, and flags latency drift against
the wisdom-recorded baseline. The :class:`Profiler` samples the launch
path (``WisdomKernel``, ``ServeEngine`` decode steps), runs always-on in
tuner evaluations (``EvalResult.info["profile"]``), and fans every profile
out to ``prof.*`` metrics and Chrome counter events.

``python -m repro_torch.prof`` exposes profile/report/roofline/diff/demo;
``KERNEL_LAUNCHER_PROF=N`` attaches a process-wide profiler ambiently.

Not ported yet: profile-guided tuning (the reference's ``guided.py``,
which needs the fitted cost model, ROADMAP.md queue 1 item 5) and the
attribution report over recorded tuning spaces (``repro.tunebench``,
item 13); :func:`classify_dataset` and :func:`render_attribution` raise.
"""

from .profile import (BOTTLENECKS, DRIFT_THRESHOLD, PROFILE_FEATURES,
                      PROFILE_VERSION, KernelProfile, ProfileVersionError,
                      classify_bottleneck, profile_feature_vector,
                      profile_fields, profile_from_workload)
from .profiler import (DEFAULT_SAMPLE_EVERY, PROF_ENV, Profiler,
                       StepProfiler, load_profiles, process_profiler,
                       prof_requested, reset_process_profiler,
                       save_profiles, summarize)
from .report import classify_dataset, render_attribution, render_profiles

__all__ = [
    "BOTTLENECKS",
    "DEFAULT_SAMPLE_EVERY",
    "DRIFT_THRESHOLD",
    "KernelProfile",
    "PROF_ENV",
    "PROFILE_FEATURES",
    "PROFILE_VERSION",
    "Profiler",
    "ProfileVersionError",
    "StepProfiler",
    "classify_bottleneck",
    "classify_dataset",
    "load_profiles",
    "process_profiler",
    "prof_requested",
    "profile_feature_vector",
    "profile_fields",
    "profile_from_workload",
    "render_attribution",
    "render_profiles",
    "reset_process_profiler",
    "save_profiles",
    "summarize",
]
