from .watchdog import StepWatchdog, StragglerReport
from .driver import InjectedFault, TrainDriver
from .crosspod import CrossPodSync

__all__ = ["StepWatchdog", "StragglerReport", "InjectedFault",
           "TrainDriver", "CrossPodSync"]
