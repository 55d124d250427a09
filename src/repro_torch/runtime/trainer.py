"""Fault-tolerant training loop on one device (counterpart of
``repro.runtime.trainer``): checkpoint and resume, preemption, stragglers.

* **Resume from latest** on start: checkpoints are atomic
  (``checkpoint/ckpt.py``) and restored in place into freshly initialised
  state. A checkpoint that the JAX package's ``Trainer`` wrote resumes too:
  its params and AdamW state go through ``models.convert``
  (``TrainArtifacts.from_jax``).
* **Preemption**: SIGTERM sets a "checkpoint, then exit" request; the loop
  commits a final checkpoint at the next step boundary.
* **Straggler monitor**: steps slower than ``threshold ×`` the rolling median
  of step times are recorded with their index.
* **Data determinism**: a batch is a pure function of the step, so a resumed
  run consumes the identical stream.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch import checkpoint as ckpt
from repro_torch.data import DataConfig, make_batch
from repro_torch.runtime.steps import place_batch


@dataclasses.dataclass
class TrainerConfig:
    """Checkpoint directory and cadence, keep ring, straggler threshold."""
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    straggler_threshold: float = 3.0
    log_every: int = 10


class StragglerMonitor:
    """Flags a step whose wall time exceeds ``threshold`` × the median of
    the last ``window`` steps (once five have been seen)."""

    def __init__(self, threshold: float, window: int = 50):
        self.threshold = threshold
        self.times: deque = deque(maxlen=window)
        self.flagged: list = []

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = False
        if len(self.times) >= 5:
            med = float(np.median(self.times))
            if dt > self.threshold * med:
                self.flagged.append((step, dt, med))
                is_straggler = True
        self.times.append(dt)
        return is_straggler


class Trainer:
    """Runs ``arts.step_fn`` (from ``make_train_step``) over
    ``make_batch(data_cfg, step)`` with checkpoints into ``tcfg.ckpt_dir``.

    hooks: optional ``{"pre_step": fn(step)}`` called before every step
    (tests inject preemptions and stalls through it).
    """

    def __init__(self, *, arts, data_cfg: DataConfig, tcfg: TrainerConfig,
                 hooks: Optional[Dict[str, Callable]] = None):
        self.arts = arts
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        self.hooks = hooks or {}
        self.monitor = StragglerMonitor(tcfg.straggler_threshold)
        self._preempted = False
        self._pending_save = None
        self.metrics_log: list = []

    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not the main thread (tests)

    def request_preemption(self):
        """Simulate a maintenance event: stop after the current step."""
        self._preempted = True

    @staticmethod
    def _state_tree(params, opt_state, step: int):
        return {"params": dict(params.named_parameters()), "opt": opt_state,
                "step": int(step)}

    def _save(self, params, opt_state, step):
        if self._pending_save is not None:
            self._pending_save.join()
        self._pending_save = ckpt.save_async(
            self.tcfg.ckpt_dir, step, self._state_tree(params, opt_state, step),
            keep=self.tcfg.keep)

    def _restore_or_init(self, seed: int):
        latest = ckpt.latest_step(self.tcfg.ckpt_dir)
        if latest is not None and ckpt.is_jax_layout(self.tcfg.ckpt_dir, latest):
            tree = ckpt.read_tree(self.tcfg.ckpt_dir, latest)
            params, opt_state = self.arts.from_jax(tree)
            return params, opt_state, int(tree["step"]) + 1
        params, opt_state = self.arts.init_fn(seed)
        start = 0
        if latest is not None:
            tree = ckpt.restore(self.tcfg.ckpt_dir, latest,
                                self._state_tree(params, opt_state, 0))
            opt_state = tree["opt"]
            start = tree["step"] + 1
        return params, opt_state, start

    def run(self, total_steps: int, seed: int = 0) -> Dict[str, Any]:
        """Train from the latest checkpoint (or from ``init_fn(seed)``) up to
        ``total_steps``, or until preempted; always ends with a checkpoint."""
        self._install_signal_handlers()
        params, opt_state, start = self._restore_or_init(seed)
        step = start
        while step < total_steps and not self._preempted:
            t0 = time.perf_counter()
            batch = place_batch(make_batch(self.data_cfg, step), self.arts.device)
            if "pre_step" in self.hooks:
                self.hooks["pre_step"](step)
            params, opt_state, metrics = self.arts.step_fn(params, opt_state,
                                                           batch, step)
            loss = float(metrics["loss"])  # also waits for the step
            dt = time.perf_counter() - t0
            self.monitor.observe(step, dt)
            self.metrics_log.append({"step": step, "loss": loss, "dt": dt})
            if step % self.tcfg.log_every == 0:
                print(f"step {step:6d} loss {loss:8.4f} "
                      f"gnorm {float(metrics.get('grad_norm', 0)):6.3f} "
                      f"dt {dt*1e3:8.1f}ms", flush=True)
            if (step + 1) % self.tcfg.ckpt_every == 0:
                self._save(params, opt_state, step)
            step += 1
        # final / preemption checkpoint at the step boundary
        self._save(params, opt_state, step - 1)
        self._pending_save.join()
        return {"params": params, "opt": opt_state, "stop_step": step,
                "preempted": self._preempted,
                "stragglers": list(self.monitor.flagged)}
