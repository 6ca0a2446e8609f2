"""Fault-tolerant training loop.

Port of src/repro/train/loop.py, with its failure model and answers:

  * process/node crash      → resume from the latest complete atomic
                              checkpoint; the data is a function of the
                              step (train/data.py), so replayed steps see
                              the same batches
  * silent data corruption  → the step's Freivalds residual; a step whose
                              residual exceeds the bound is discarded (the
                              pre-step params and optimizer state carry
                              on, which the out-of-place update keeps
                              intact) and counted
  * stragglers              → each step's wall time against the running
                              median of the last 50; a step slower than
                              `straggler_factor`× median is reported to
                              the caller's hook
  * checkpoint corruption   → a SHA-verified restore that fails falls back
                              to the checkpoint before it

A step that raises RuntimeError (torch's errors, CUDA's included) is a
crash. Each step's SDC key is a seed derived from (seed, step); each
batch is moved to the parameters' device.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .checkpoint import CheckpointManager

#: the loop's clock (seconds); a test may replace it with a fake one
clock = time.perf_counter


@dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    keep_last: int = 3
    straggler_factor: float = 3.0
    sdc_threshold: float = 1e-3
    max_restarts: int = 5


@dataclass
class LoopReport:
    steps_run: int = 0
    restarts: int = 0
    sdc_rejects: int = 0
    straggler_events: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    grad_norms: list = field(default_factory=list)  # where steps report one


def step_seed(seed: int, step: int) -> int:
    """The step's key: a 63-bit seed that depends on (seed, step) alone."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _device(params) -> torch.device:
    return next(iter(params.parameters())).device


def run_training(
    train_step: Callable,
    params,
    opt_state,
    data_fn: Callable[[int], dict],
    ckpt: CheckpointManager,
    loop_cfg: LoopConfig,
    *,
    key: int | None = None,
    fault_injector: Callable[[int], None] | None = None,
    on_straggler: Callable | None = None,
) -> tuple[object, object, LoopReport]:
    """Run (and if needed re-run) steps until total_steps, surviving
    injected faults. data_fn(step) -> batch (deterministic); key: the
    seed the steps' keys derive from (default 0)."""
    report = LoopReport()
    seed = 0 if key is None else int(key)
    device = _device(params)

    # resume if a checkpoint exists
    start = 0
    state_tpl = {"params": params, "opt": opt_state}
    if ckpt.latest_step() is not None:
        try:
            restored, at = ckpt.restore(state_tpl)
            params, opt_state = restored["params"], restored["opt"]
            start = at
        except IOError:
            steps = ckpt.all_steps()
            if len(steps) > 1:
                restored, at = ckpt.restore(state_tpl, steps[-2])
                params, opt_state = restored["params"], restored["opt"]
                start = at

    step = start
    times: list[float] = []
    restarts = 0
    while step < loop_cfg.total_steps:
        try:
            if fault_injector is not None:
                fault_injector(step)  # may raise to simulate a node failure
            t0 = clock()
            batch = {k: v.to(device) for k, v in data_fn(step).items()}
            new_params, new_opt, metrics = train_step(
                params, opt_state, batch, step_seed(seed, step))
            loss = float(metrics["loss"])
            dt = clock() - t0

            # SDC gate: reject the update, keep the step counter moving
            resid = float(metrics.get("sdc_residual", 0.0))
            if resid > loop_cfg.sdc_threshold:
                report.sdc_rejects += 1
            else:
                params, opt_state = new_params, new_opt

            times.append(dt)
            if len(times) >= 5:
                med = statistics.median(times[-50:])
                if dt > loop_cfg.straggler_factor * med:
                    report.straggler_events.append((step, dt, med))
                    if on_straggler is not None:
                        on_straggler(step, dt, med)
            report.losses.append(loss)
            if "grad_norm" in metrics:
                report.grad_norms.append(float(metrics["grad_norm"]))
            report.steps_run += 1
            step += 1
            if step % loop_cfg.checkpoint_every == 0:
                ckpt.save(step, {"params": params, "opt": opt_state})
        except RuntimeError:
            restarts += 1
            report.restarts = restarts
            if restarts > loop_cfg.max_restarts:
                raise
            # restart path: reload the latest complete checkpoint
            ckpt.wait()
            if ckpt.latest_step() is not None:
                restored, at = ckpt.restore(state_tpl)
                params, opt_state = restored["params"], restored["opt"]
                step = at
            else:
                step = 0
    ckpt.save(step, {"params": params, "opt": opt_state}, blocking=True)
    return params, opt_state, report
