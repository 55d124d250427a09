"""Fault-tolerant training loop on one device or over a training mesh
(counterpart of ``repro.runtime.trainer``): checkpoint and resume,
preemption, stragglers.

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
* **Over a mesh** (``arts`` from ``make_train_step(mesh=)``): every rank runs
  the loop on its shard of the state and its rows of each batch;
  checkpoints are mesh-agnostic (gathered to rank 0, which writes), so a
  run resumes on another mesh or on one device (elastic re-scaling); a
  preemption request is agreed at each step boundary (an all-reduce MAX of
  the ranks' flags), so all ranks stop at the same step; only rank 0
  prints.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.data import DataConfig, make_batch
from repro_torch.distributed.collectives import all_reduce_
from repro_torch.distributed.parallel import shard_batch
from repro_torch.runtime.steps import place_batch


@dataclasses.dataclass
class TrainerConfig:
    """Checkpoint directory and cadence, keep ring, straggler threshold;
    ``final_ckpt``: commit a checkpoint when the run reaches its last step
    (a preemption always commits one)."""
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    straggler_threshold: float = 3.0
    log_every: int = 10
    final_ckpt: bool = True


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

    batch_shardings: on a mesh, the batch's shardings
    (``arts.shardings["batch"]``): only this rank's rows of each host batch
    are copied to its device. With None a mesh still trains correctly: the
    whole batch is copied, and the rank keeps its rows on the device.
    """

    def __init__(self, *, arts, data_cfg: DataConfig, tcfg: TrainerConfig,
                 batch_shardings=None,
                 hooks: Optional[Dict[str, Callable]] = None):
        self.arts = arts
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        self.batch_shardings = batch_shardings
        self.mesh = None if arts.plan is None else arts.plan.mesh
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

    def _shardings(self):
        """The state tree's shardings on a mesh (None on one device)."""
        sh = self.arts.shardings
        return None if sh is None else {"params": sh["params"], "opt": sh["opt"]}

    def _log(self, msg: str) -> None:
        if self.mesh is None or self.mesh.rank == 0:
            print(msg, flush=True)

    def _stop(self) -> bool:
        """The preemption request, agreed by every rank of a mesh."""
        if self.mesh is None:
            return self._preempted
        flag = torch.tensor([float(self._preempted)], device=self.arts.device)
        all_reduce_(flag, self.mesh, tuple(self.mesh.shape), "max")
        self._preempted = bool(flag.item())
        return self._preempted

    def _place(self, batch):
        if self.batch_shardings is not None:
            return place_batch(batch, self.arts.device, self.batch_shardings)
        batch = place_batch(batch, self.arts.device)
        if self.mesh is not None:
            batch = shard_batch(batch, self.arts.shardings["batch"])
        return batch

    def _save(self, params, opt_state, step):
        if self._pending_save is not None:
            self._pending_save.join()
        self._pending_save = ckpt.save_async(
            self.tcfg.ckpt_dir, step, self._state_tree(params, opt_state, step),
            keep=self.tcfg.keep, shardings=self._shardings())

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
                                self._state_tree(params, opt_state, 0),
                                shardings=self._shardings())
            opt_state = tree["opt"]
            start = tree["step"] + 1
        return params, opt_state, start

    def run(self, total_steps: int, seed: int = 0) -> Dict[str, Any]:
        """Train from the latest checkpoint (or from ``init_fn(seed)``) up to
        ``total_steps``, or until preempted; ends with a checkpoint (at
        ``total_steps`` only with ``tcfg.final_ckpt``)."""
        self._install_signal_handlers()
        params, opt_state, start = self._restore_or_init(seed)
        step = start
        while step < total_steps and not self._stop():
            t0 = time.perf_counter()
            batch = self._place(make_batch(self.data_cfg, step))
            if "pre_step" in self.hooks:
                self.hooks["pre_step"](step)
            params, opt_state, metrics = self.arts.step_fn(params, opt_state,
                                                           batch, step)
            loss = float(metrics["loss"])  # also waits for the step
            dt = time.perf_counter() - t0
            self.monitor.observe(step, dt)
            self.metrics_log.append({"step": step, "loss": loss, "dt": dt})
            if step % self.tcfg.log_every == 0:
                aux = (f"moe_aux {float(metrics['moe_aux']):7.4f} "
                       if "moe_aux" in metrics else "")
                self._log(f"step {step:6d} loss {loss:8.4f} "
                          f"gnorm {float(metrics.get('grad_norm', 0)):6.3f} "
                          f"{aux}dt {dt*1e3:8.1f}ms")
            if (step + 1) % self.tcfg.ckpt_every == 0:
                self._save(params, opt_state, step)
            step += 1
        # final / preemption checkpoint at the step boundary
        if self.tcfg.final_ckpt or self._preempted:
            self._save(params, opt_state, step - 1)
        if self._pending_save is not None:
            self._pending_save.join()
        return {"params": params, "opt": opt_state, "stop_step": step,
                "preempted": self._preempted,
                "stragglers": list(self.monitor.flagged)}
