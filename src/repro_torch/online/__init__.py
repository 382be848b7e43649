"""Online autotuning: traffic-driven tuning with live wisdom promotion.

Port of ``repro.online``. Beyond-paper subsystem (builds on §4.4 wisdom
files and the §4.5 selection heuristic). The paper's workflow is strictly
offline — capture a launch, tune it out-of-band, ship the wisdom file
(§4.2-§4.4). Any scenario not tuned ahead
of time falls through the §4.5 selection heuristic to a fuzzy match or the
default config, forever. This subsystem turns those wisdom *misses* into
background tuning work driven by the traffic itself:

* :mod:`.tracker`   — detects misses, accumulates per-scenario demand;
* :mod:`.budget`    — hard per-launch overhead budget for background work;
* :mod:`.scheduler` — budgeted cost-model screening + successive-halving
  live trials (epsilon-greedy over real launches);
* :mod:`.promotion` — confident winners pass the correctness gate on the
  card and become ``online``-provenance wisdom records, hot-swapped
  without a compile stall;
* :mod:`.service`   — the :class:`OnlineTuner` facade ``WisdomKernel``
  calls into, plus ``KERNEL_LAUNCHER_ONLINE`` auto-attach support.

Prefer offline ``tuner.tune`` when you can enumerate scenarios ahead of
time (bigger budgets, no serving-path overhead at all); enable online
tuning when the scenario set is open-ended and wisdom must follow traffic.
"""

from .budget import (BudgetTimer, OverheadBudget, OverheadMeter,
                     ONLINE_BUDGET_MS_ENV, ONLINE_SCREENS_ENV)
from .promotion import Promotion, PromotionPipeline
from .scheduler import TrialScheduler
from .service import (OnlineTuner, enable_online_tuning, online_requested,
                      ONLINE_ENV, ONLINE_EPSILON_ENV)
from .tracker import (MISS_TIERS, ScenarioStats, ScenarioTracker,
                      ScenarioKey, format_key, parse_key)

__all__ = [
    "BudgetTimer", "OverheadBudget", "OverheadMeter",
    "ONLINE_BUDGET_MS_ENV", "ONLINE_SCREENS_ENV",
    "Promotion", "PromotionPipeline",
    "TrialScheduler",
    "OnlineTuner", "enable_online_tuning", "online_requested",
    "ONLINE_ENV", "ONLINE_EPSILON_ENV",
    "MISS_TIERS", "ScenarioStats", "ScenarioTracker", "ScenarioKey",
    "format_key", "parse_key",
]
