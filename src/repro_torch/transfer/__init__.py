"""Cross-device wisdom transfer: serve good configs on devices never tuned.

Port of ``repro.transfer``, onto (and from) the H100's ``gpu-h100`` spec.

Beyond-paper subsystem. The paper's headline result is portability —
wisdom captured "for different GPUs, input domains, and precisions" —
yet selection on a device family with no recorded tuning runs degrades
to coarse scenario-distance fallback. This package closes that gap by
*predicting* instead of re-tuning, following the cross-vendor transfer
results of Lurati et al. ("Bringing Auto-tuning to HIP") and the
surrogate-ranking results of Schoonhoven et al. ("Benchmarking
optimization algorithms for auto-tuning GPU kernels"):

* :mod:`.model`     — :class:`DeviceModel`: capability-vector ratios and
  similarity between a tuned source device and an untuned target;
* :mod:`.predictor` — re-rank a source device's recorded tuning space
  through the ridge surrogate, calibrated per config by the capability
  model, into ``transfer``-provenance wisdom records with a confidence
  score; ``Wisdom.select`` serves them from a dedicated tier (below
  exact measurements, above scenario-distance fallback) only above
  :data:`~repro_torch.core.wisdom.TRANSFER_MIN_CONFIDENCE`;
* :mod:`.score`     — held-out-device evaluation (fraction-of-optimum
  vs the cold fallback baseline), against a space recorded on the target,
  such as the card's own wall-clock recording;
* :mod:`.cli`       — ``python -m repro_torch.transfer``
  (predict / score / export).

The prediction is not the end of the loop: the fleet coordinator's
``check_transfers`` (:class:`repro_torch.fleet.Coordinator`) holds each
transferred record's ``predicted_us`` to the serve latency hosts publish
on the ``latency`` channel, and enqueues verification tuning for a
scenario whose observation is worse than the prediction by more than
``TRANSFER_VERIFY_TOLERANCE``; the measured record it assembles beats the
transferred one in every merge (:func:`repro_torch.distrib.merge_wisdom`).
Docs: ``docs/transfer-tuning.md``.
"""

from .model import DeviceModel
from .predictor import (TransferPrediction, TransferResult,
                        transfer_scenario, transfer_store)
from .score import (dump_holdout_report, fraction_of_optimum,
                    holdout_report)

__all__ = [
    "DeviceModel",
    "TransferPrediction", "TransferResult", "transfer_scenario",
    "transfer_store",
    "dump_holdout_report", "fraction_of_optimum", "holdout_report",
]
