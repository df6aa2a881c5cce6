"""Fault tolerance for long training runs: step retry from checkpoint,
straggler detection, elastic re-meshing (port of
``repro.training.fault_tolerance``).

On a real fleet the failure signal is a runtime error or a missed heartbeat;
here failures are injected (tests) or surfaced as exceptions.  Recovery
invariants:

  * the data loader is a pure function of (seed, step) -> a restart replays
    exactly;
  * checkpoints are atomic (``checkpoint.py``) -> a crash mid-save is
    invisible;
  * restore places the state on any device -> the surviving device set may
    differ from the failed one.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable

log = logging.getLogger("repro_torch.fault")


class FailureInjector:
    """Deterministic failure schedule for tests: fail at given steps, once each."""

    def __init__(self, fail_at: set[int] | None = None):
        self.fail_at = set(fail_at or ())
        self.failed: set[int] = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.failed:
            self.failed.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


@dataclass
class StragglerDetector:
    """EWMA step-time monitor.  On a fleet, flagged steps trigger backup-task
    dispatch (MapReduce speculative execution -- the paper's substrate does exactly
    this for slow reducers); here we record and expose the events."""
    alpha: float = 0.9
    threshold: float = 3.0
    ewma: float | None = None
    events: list[tuple[int, float, float]] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = dt > self.threshold * self.ewma
        if is_straggler:
            self.events.append((step, dt, self.ewma))
            log.warning("straggler: step %d took %.3fs (ewma %.3fs)", step, dt,
                        self.ewma)
        self.ewma = self.alpha * self.ewma + (1 - self.alpha) * dt
        return is_straggler


def run_with_recovery(*, n_steps: int, step_fn: Callable, state, batch_fn: Callable,
                      ckpt, ckpt_every: int = 10, max_retries: int = 5,
                      injector: FailureInjector | None = None,
                      straggler: StragglerDetector | None = None,
                      on_restore: Callable | None = None):
    """Generic recovering training loop.

    step_fn(state, batch) -> (state, metrics);  state is any tree.
    batch_fn(step) -> batch (deterministic).
    Returns (state, history, n_restarts).
    """
    step = 0
    if ckpt.latest_step() is not None:
        state, extras = ckpt.restore(ckpt.latest_step(), state)
        step = extras.get("next_step", 0)
    history = []
    retries = 0
    while step < n_steps:
        try:
            t0 = time.perf_counter()
            if injector is not None:
                injector.maybe_fail(step)
            state, metrics = step_fn(state, batch_fn(step))
            dt = time.perf_counter() - t0
            if straggler is not None:
                straggler.observe(step, dt)
            history.append(metrics)
            step += 1
            if step % ckpt_every == 0:
                ckpt.save(step, state, extras={"next_step": step})
        except Exception as e:  # noqa: BLE001 -- any device failure
            retries += 1
            if retries > max_retries:
                raise
            log.warning("step %d failed (%s); restoring from checkpoint", step, e)
            last = ckpt.latest_step()
            if last is None:
                step = 0  # no checkpoint yet: replay from scratch (loader is pure)
                continue
            state, extras = ckpt.restore(last, state)
            step = extras.get("next_step", 0)
            if on_restore is not None:
                state = on_restore(state)
    ckpt.wait()
    return state, history, retries


def elastic_remesh(make_step_fn: Callable, make_mesh_fn: Callable, state, ckpt):
    """Elastic scaling: rebuild the mesh from the live ranks, restore the
    latest checkpoint onto it, and return a fresh step.

    ``make_mesh_fn()`` returns the new ``launch.mesh.DataMesh`` (after a
    failure, over the surviving ranks); the restore puts every leaf of
    ``state`` on that mesh's device.  ``repro``'s ``shardings_fn`` has no
    counterpart: a data-mesh rank holds the whole state.
    """
    mesh = make_mesh_fn()
    last = ckpt.latest_step()
    if last is not None:
        state, _ = ckpt.restore(last, state, device=mesh.device)
    return make_step_fn(mesh), state, mesh
