"""Three-term roofline model of one NVIDIA H100 SXM (counterpart of
``repro.perf.roofline``, whose constants are a TPU's):

    compute    = flops_per_device / PEAK_FLOPS["bfloat16"]
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / NVLINK_BW

plus MODEL_FLOPS = 6·N·D (train) / 2·N·D (fwd-only) and the useful-compute
ratio MODEL_FLOPS / (flops · cards), which exposes remat/dispatch waste.

The card's constants live here and nowhere else in the port: the kernel
bounds of ``chip_smoke.py`` and ``perf/*_times.py`` and the decode planner
of ``perf/autotune.py`` read them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

# --- H100 SXM hardware constants (per card) -------------------------------
# NVIDIA's H100 data sheet, SXM part, dense rates without sparsity, at the
# full 700 W power limit.
HBM_BW = 3.35e12            # bytes/s of HBM3
# tensor-core peaks: an f32 product on tensor cores goes through TF32
PEAK_FLOPS: Dict[str, float] = {"float32": 495e12, "bfloat16": 989e12}
PEAK_FLOPS_NO_TENSOR_CORES = 67e12   # f32 FLOP/s outside the tensor cores
# NVLink 4: 900 GB/s a card, both directions together (the data sheet's
# figure), so 450 GB/s each way; it takes the place of the TPU's per-link
# ICI rate in the collective term.
NVLINK_BW = 450e9
HBM_PER_CHIP = 80e9         # 80 GB HBM3; hbm_per_chip() reads the card


def hbm_per_chip() -> float:
    """Device memory of card 0 in bytes where a card is present, else the
    H100 SXM's 80 GB."""
    import torch
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return HBM_PER_CHIP


@dataclasses.dataclass
class Roofline:
    """One cell's three-term roofline plus the inputs it was built from."""
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_per_dev: float
    hlo_bytes_per_dev: float        # bytes accessed (fusion-blind upper bound)
    mem_bytes_model: float          # compulsory-traffic model (roofline term)
    coll_bytes_per_dev: float
    chips: int

    @property
    def bound(self) -> str:
        """Which of the three terms dominates ("compute"/"memory"/"collective")."""
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Ideal-overlap model: the step takes max(terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_compute_ratio(self) -> float:
        """MODEL_FLOPS / total flops — exposes remat/dispatch waste."""
        total = self.hlo_flops_per_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """MODEL_FLOPS-based utilisation at the roofline-ideal step time."""
        t = self.step_time_s
        if t == 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS["bfloat16"] * t)

    def as_dict(self) -> Dict:
        """Flat dict form for JSON artifacts."""
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bound": self.bound,
            "step_time_s": self.step_time_s, "mfu": self.mfu,
            "model_flops": self.model_flops,
            "useful_compute_ratio": self.useful_compute_ratio,
            "hlo_flops_per_dev": self.hlo_flops_per_dev,
            "hlo_bytes_per_dev_upper_bound": self.hlo_bytes_per_dev,
            "mem_bytes_model": self.mem_bytes_model,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "chips": self.chips,
        }


def model_flops_for(cfg, shape, *, step_kind: str) -> float:
    """6·N·D for train, 2·N·D for fwd-only; MoE uses N_active. Decode D =
    global_batch tokens (one step). ``shape`` has ``seq_len`` and
    ``global_batch``."""
    n = cfg.active_param_count() if cfg.moe is not None else cfg.param_count()
    if step_kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if step_kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch   # decode: one token a sequence


def build(cfg, shape, *, step_kind: str, chips: int, hlo_flops_per_dev: float,
          hlo_bytes_per_dev: float, coll_bytes_per_dev: float,
          mem_bytes_model: float = 0.0) -> Roofline:
    """Assemble a Roofline from measured or counted per-device flops and
    bytes (module docstring terms) at the bf16 tensor-core peak, as JAX's
    at its chip's bf16 peak."""
    mem = mem_bytes_model if mem_bytes_model > 0 else hlo_bytes_per_dev
    return Roofline(
        compute_s=hlo_flops_per_dev / PEAK_FLOPS["bfloat16"],
        memory_s=mem / HBM_BW,
        collective_s=coll_bytes_per_dev / NVLINK_BW,
        model_flops=model_flops_for(cfg, shape, step_kind=step_kind),
        hlo_flops_per_dev=hlo_flops_per_dev,
        hlo_bytes_per_dev=hlo_bytes_per_dev,
        mem_bytes_model=mem,
        coll_bytes_per_dev=coll_bytes_per_dev,
        chips=chips,
    )
