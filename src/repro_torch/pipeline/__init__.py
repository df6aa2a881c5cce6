"""Job engine: ``plan`` types a method as stage descriptions, ``stages`` holds
the shared stage implementations, ``executor`` runs a plan on one device --
whole-corpus (``run_plan``) or over fixed-size token waves
(``WaveExecutor``)."""
from . import plan, stages
from .executor import DoubleBufferedDriver, WaveExecutor, WavePartial, run_plan
from .plan import JobPlan, plan_for
from .stages import canonical_stats

__all__ = ["plan", "stages", "WaveExecutor", "WavePartial",
           "DoubleBufferedDriver", "run_plan", "JobPlan", "plan_for",
           "canonical_stats"]
