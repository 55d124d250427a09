"""Paged-KV serving of the port: block-table caches + continuous batching
(counterpart of ``repro.serving``, one device).

The host layer — ``paged_cache`` (refcounted page allocator, content-
addressed prefix index, block tables), ``state_cache``, ``scheduler``
(admission → grow → preempt → re-prefill), ``drafter`` (prompt-lookup
drafts for speculative decoding), ``outcomes`` (typed request outcomes) and
``faults`` (seeded, replayable fault injection) — is numpy only and a copy
of the JAX package's modules, apart from their import prefix
(``tests/test_torch_engine.py`` holds them equal). ``engine`` is the serving
loop over ``runtime.steps.make_serve_steps(paged=...)``, whose paged
attention runs the CUDA kernel ``kernels/csrc/flash_decode.cu``
(``core.attention.spark_paged_decode``).
"""

from repro_torch.serving.drafter import NgramDrafter, longest_accept
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import FaultEvent, FaultPlan, InjectedCrash
from repro_torch.serving.outcomes import (Outcome, RequestResult,
                                          outcome_counts, untyped_rids)
from repro_torch.serving.paged_cache import (BlockTables, PageAllocator,
                                             PagedCacheConfig, PrefixIndex,
                                             TRASH_PAGE)
from repro_torch.serving.scheduler import (AdmissionImpossible, ActiveSeq,
                                           Request, Scheduler)
from repro_torch.serving.state_cache import StateCache

__all__ = [
    "ServingEngine", "BlockTables", "PageAllocator", "PagedCacheConfig",
    "PrefixIndex", "TRASH_PAGE", "ActiveSeq", "Request", "Scheduler",
    "NgramDrafter", "longest_accept", "StateCache", "AdmissionImpossible",
    "Outcome", "RequestResult", "outcome_counts", "untyped_rids",
    "FaultEvent", "FaultPlan", "InjectedCrash",
]
