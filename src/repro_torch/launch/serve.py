"""Serving launcher of the port: batched prefill + greedy decode on the
contiguous cache, or continuous batching over a paged cache with
``--paged``, sharded over ``--mesh N`` ranks (counterpart of
``repro.launch.serve`` without ``--autotune``).

On the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --batch 8 --prompt-len 512 --gen 32

Paged continuous batching (ragged synthetic requests through
``serving.ServingEngine``; ``--lazy``, ``--share-prefix``,
``--prefill-chunk``, ``--speculate``, ``--fault-plan`` as in JAX):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --paged --requests 16 --max-batch 8 --prompt-len 512 --gen 64

Distributed paged serving: the page pool sharded over N ranks, one
process each, spawned by the launcher (``launch/mesh.py``); weights are
replicated. ``--dist-backend nccl`` (the default on cuda) needs a card a
rank; ranks that share one card need ``--dist-backend gloo``:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --paged --mesh 2 --dist-backend gloo --requests 16 --max-batch 8

On the CPU, at smoke size (the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --smoke --device cpu --batch 2 --prompt-len 16 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --smoke --device cpu --paged --requests 4 --prompt-len 16 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --smoke --device cpu --paged --mesh 2 --dist-backend gloo \\
      --requests 4 --prompt-len 16 --gen 4

The hybrid recurrentgemma-2b (RG-LRU and local-attention blocks) serves on
both caches, not over ``--mesh``; ``--share-prefix`` and ``--speculate``
exit with the engine's refusal, as in JAX:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma_2b \\
      --smoke --device cpu [--paged]

The MoE archs (deepseek-moe-16b, dbrx-132b) serve on every path, the
paged engine's modes and ``--mesh`` included (expert routing is stateless
per token):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek_moe_16b \\
      --smoke --device cpu [--paged [--mesh 2 --dist-backend gloo]]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.attention import IMPLS
from repro_torch.launch import mesh as pool_mesh
from repro_torch.models import lm
from repro_torch.runtime.steps import ServeArtifacts, make_serve_steps


@dataclasses.dataclass
class Generation:
    """What one greedy run produced: tokens [B, gen], the logits behind them
    ([B, Vpad] each: prefill's, then every decode step's), and the host-clock
    seconds of the prefill and of the decode loop (each ending in a device
    synchronise)."""
    tokens: torch.Tensor
    logits: List[torch.Tensor]
    prefill_s: float
    decode_s: float


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(arts: ServeArtifacts, params, prompt, gen: int,
                    vocab_size: int, *, feed: Optional[torch.Tensor] = None
                    ) -> Generation:
    """Prefill ``prompt [B, S]``, then ``gen - 1`` greedy decode steps.

    feed: optional [B, gen] tokens to feed to the decode steps in place of
    this run's own argmax (teacher forcing), so two impls can be compared
    step by step on one token stream; ``tokens`` stays this run's argmax.
    """
    b, s = prompt.shape
    caches = arts.cache_init_fn()
    _sync(prompt.device)
    t0 = time.perf_counter()
    logits, caches = arts.prefill_fn(params, prompt, caches)
    _sync(prompt.device)
    prefill_s = time.perf_counter() - t0
    out_logits = [logits]
    toks = [logits[:, :vocab_size].argmax(dim=-1)]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        tok = toks[-1] if feed is None else feed[:, i]
        logits, caches = arts.decode_fn(params, tok, caches, s + i)
        out_logits.append(logits)
        toks.append(logits[:, :vocab_size].argmax(dim=-1))
    _sync(prompt.device)
    decode_s = time.perf_counter() - t0
    return Generation(torch.stack(toks, dim=1), out_logits, prefill_s, decode_s)


def main(argv=None):
    """Parse arguments, build the model with random weights, serve once and
    print the summary line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--impl", default="kernel", choices=IMPLS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-splits", type=int, default=0,
                    help="split-KV decode: parallel KV partitions per "
                         "(batch, kv-head) row (0 = 1)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--paged", action="store_true",
                    help="paged-KV continuous batching (ragged requests)")
    ap.add_argument("--mesh", default="",
                    help="--paged: shard the page pool over this many ranks "
                         "(the pool axis only, e.g. 2), one process each")
    ap.add_argument("--dist-backend", default=None,
                    choices=pool_mesh.BACKENDS,
                    help="--mesh: torch.distributed backend (default nccl "
                         "on cuda, a card a rank; gloo on the CPU and for "
                         "ranks that share a card)")
    ap.add_argument("--requests", type=int, default=8,
                    help="--paged: synthetic requests to serve")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="--paged: concurrent decode slots")
    ap.add_argument("--lazy", action="store_true",
                    help="--paged: lazy page growth + preemption/re-prefill "
                         "instead of eager full-budget reservation")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="--paged: override the page-pool size (0 = auto; "
                         "shrink it to watch --lazy preempt)")
    ap.add_argument("--share-prefix", action="store_true",
                    help="--paged: content-addressed prefix caching + "
                         "copy-on-write pages (requests then share a common "
                         "system prompt so the cache has something to hit)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="--paged: max prompt tokens prefilled per engine "
                         "iteration (0 = whole prompts at once)")
    ap.add_argument("--speculate", type=int, default=0,
                    help="--paged: speculative decoding — verify up to this "
                         "many prompt-lookup draft tokens per decode step "
                         "(0 = off); token-identical to plain greedy decode")
    ap.add_argument("--deadline-ms", type=float, default=0,
                    help="--paged: per-request wall-clock deadline in "
                         "milliseconds; expired requests terminate with a "
                         "TIMEOUT outcome (0 = no deadline)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="--paged: bounded admission queue — submissions "
                         "past this many waiting requests shed with a SHED "
                         "outcome (0 = unbounded)")
    ap.add_argument("--fault-plan", type=int, default=-1,
                    help="--paged: seed a replayable chaos FaultPlan "
                         "(serving/faults.py) injecting pool exhaustion, "
                         "preemption storms, freed-page poison, NaN logits "
                         "and cancellations (-1 = off)")
    args = ap.parse_args(argv)

    try:
        cfg = (configs.smoke_config(args.arch) if args.smoke
               else configs.get_config(args.arch))
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    device = torch.device(args.device)
    n_ranks = parse_mesh(args.mesh)
    if n_ranks and not args.paged:
        raise SystemExit("--mesh shards the page pool: it needs --paged (the "
                         "contiguous cache over a mesh needs the sharding "
                         "rules, not yet ported)")
    if n_ranks and "rec" in cfg.block_pattern:
        raise SystemExit(f"{cfg.name}: serving recurrent blocks over --mesh "
                         f"is not yet ported")
    if args.paged:
        return serve_paged(cfg, args, device, n_ranks)

    arts = make_serve_steps(cfg, impl=args.impl,
                            max_len=args.prompt_len + args.gen,
                            batch=args.batch, num_splits=args.num_splits or 1,
                            torch_chunk=min(1024, args.prompt_len),
                            device=device)
    params = lm.init_params(cfg, seed=args.seed, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    res = greedy_generate(arts, params, prompt, args.gen, cfg.vocab_size)
    steps = args.gen - 1
    print(f"prefill: {args.batch}x{args.prompt_len} in {res.prefill_s*1e3:.1f}ms; "
          f"decode: {steps} steps in {res.decode_s*1e3:.1f}ms "
          f"({steps*args.batch/max(res.decode_s,1e-9):.1f} tok/s)")
    print("generated (first row):", res.tokens[0, :16].cpu().numpy())
    return res


def paged_requests(cfg, pcfg, args, rs: np.random.RandomState):
    """The synthetic ragged requests of ``--paged``, drawn as JAX's launcher
    draws them: prompt and generation lengths uniform in 25 %–100 % of the
    nominal ones; with ``--share-prefix`` every prompt opens with one common
    system prompt of half the nominal length; with ``--speculate`` the prompt
    tiles an 8-token motif (n-gram repeats for the drafter to match)."""
    system = (rs.randint(0, cfg.vocab_size, size=max(1, args.prompt_len // 2))
              if args.share_prefix else np.zeros(0, np.int64))
    reqs = []
    for _ in range(args.requests):
        plen = int(rs.randint(max(1, args.prompt_len // 4), args.prompt_len + 1))
        gen = int(rs.randint(max(1, args.gen // 4), args.gen + 1))
        if args.speculate:
            motif = rs.randint(0, cfg.vocab_size, size=8)
            tail = np.tile(motif, -(-plen // 8))[:plen]
        else:
            tail = rs.randint(0, cfg.vocab_size, size=plen)
        reqs.append((np.concatenate([system, tail])[:pcfg.max_seq_len
                                                    - args.gen - 1], gen))
    return reqs


def parse_mesh(spec: str) -> int:
    """``--mesh``: "" (no mesh) → 0, "N" → N ranks on the pool axis. The
    JAX launcher's multi-axis forms ("DxM", ...) need the sharding rules,
    not yet ported."""
    if not spec:
        return 0
    if not spec.isdigit() or int(spec) < 1:
        raise SystemExit(f"--mesh {spec!r}: the port shards the page pool "
                         f"over one axis, give its size (e.g. --mesh 2); "
                         f"data / pod axes need the sharding rules, not yet "
                         f"ported")
    return int(spec)


def _paged_config(args, n_shards: int):
    """The pool and prefill row of ``--paged`` (JAX's sizing): roughly half
    the requests fit at once, so the scheduler has to evict and admit, then
    the pool is padded to a multiple of the shard count (one trash page a
    shard)."""
    from repro_torch.serving import PagedCacheConfig

    budget = args.prompt_len + args.gen
    pages_per_seq = -(-budget // args.page_size) + 1
    num_pages = args.num_pages or (n_shards + max(2, args.requests // 2)
                                   * pages_per_seq)
    num_pages = -(-num_pages // n_shards) * n_shards
    pcfg = PagedCacheConfig(page_size=args.page_size, max_batch=args.max_batch,
                            max_pages_per_seq=pages_per_seq,
                            num_pages=num_pages, num_shards=n_shards)
    # lazy: a preempted row re-prefills prompt + generated, so a prefill row
    # must hold a full budget
    prefill_len = max(args.prompt_len, args.page_size)
    if args.lazy:
        prefill_len = max(prefill_len, budget)
    return pcfg, prefill_len


def _fault_plan(args):
    from repro_torch.serving import FaultPlan
    return FaultPlan(seed=args.fault_plan) if args.fault_plan >= 0 else None


def _run_engine(cfg, args, device, mesh=None):
    """Build the model and the engine (on this rank's shard under a
    ``mesh``) and serve the synthetic requests; returns ``(outputs, stats,
    engine)``."""
    from repro_torch.serving import ServingEngine

    params = lm.init_params(cfg, seed=args.seed, device=device)
    pcfg, prefill_len = _paged_config(args, mesh.size if mesh else 1)
    try:
        eng = ServingEngine(cfg, pcfg, params, impl=args.impl, device=device,
                            mesh=mesh, prefill_len=prefill_len, lazy=args.lazy,
                            num_splits=args.num_splits or None,
                            share_prefix=args.share_prefix,
                            prefill_chunk=args.prefill_chunk or None,
                            speculate_k=args.speculate or None,
                            deadline_ms=args.deadline_ms or None,
                            max_queue=args.max_queue or None,
                            fault_plan=_fault_plan(args))
    except ValueError as e:      # a mode the engine refuses for this arch
        raise SystemExit(str(e)) from None
    rs = np.random.RandomState(args.seed)
    out, stats = eng.run(paged_requests(cfg, pcfg, args, rs))
    return out, stats, eng


def _serve_rank(mesh, device, cfg, args):
    """One rank of ``--paged --mesh N``: what rank 0 prints, from every rank
    (the parent checks that they agree)."""
    out, stats, eng = _run_engine(cfg, args, device, mesh)
    return out, stats, eng.results


def serve_paged(cfg, args, device, n_ranks: int = 0):
    """Continuous batching over ragged synthetic requests (paged KV cache),
    on one device or, with ``n_ranks``, sharded over that many spawned
    ranks; prints JAX's summary lines and returns ``(outputs, stats,
    engine)``, or ``(outputs, stats, per-rank (outputs, stats, results))``
    under a mesh (rank 0's outputs and stats, equal on every rank)."""
    plan = _fault_plan(args)
    if plan is not None:
        print(f"fault plan (seed {plan.seed}): "
              + " ".join(f"{e.kind}@{e.step}" for e in plan.events))
    if args.num_splits:
        print(f"decode num_splits: {args.num_splits}")
    if n_ranks:
        backend = args.dist_backend or pool_mesh.default_backend(device.type)
        ranks = pool_mesh.run_ranks(_serve_rank, n_ranks, (cfg, args),
                                    backend=backend, device_type=device.type)
        devices = ", ".join(str(pool_mesh.rank_device(r, device.type))
                            for r in range(n_ranks))
        print(f"mesh: {n_ranks} ranks on the pool axis, backend {backend}, "
              f"devices {devices}")
        out, stats, results = ranks[0]
        for r, (o, st, _) in enumerate(ranks[1:], 1):
            same = set(o) == set(out) and all(np.array_equal(o[k], out[k])
                                              for k in out)
            if not same or st != stats:
                raise RuntimeError(f"rank {r} served other outputs or stats "
                                   f"than rank 0")
        _print_summary(args, out, stats, results)
        return out, stats, ranks
    out, stats, eng = _run_engine(cfg, args, device)
    _print_summary(args, out, stats, eng.results)
    return out, stats, eng


def _print_summary(args, out, stats, results):
    """JAX's summary lines of a paged run."""
    mode = "lazy" if args.lazy else "eager"
    print(f"served {len(out)} requests ({stats['generated_tokens']:.0f} tokens) "
          f"in {stats['wall_s']*1e3:.1f}ms: {stats['tokens_per_s']:.1f} tok/s, "
          f"{stats['decode_steps']:.0f} decode steps, "
          f"{mode} page utilization {stats['mean_utilization']:.1%}")
    print(f"scheduler: {stats['preemptions']:.0f} preemptions, "
          f"{stats['pages_grown']:.0f} pages grown lazily, "
          f"{stats['pages_reclaimed']:.0f} out-of-window pages reclaimed")
    if args.share_prefix or args.prefill_chunk:
        print(f"prefix/chunking: {stats['prefill_tokens']:.0f} prompt tokens "
              f"prefilled, {stats['prefill_tokens_skipped']:.0f} skipped via "
              f"prefix hits, {stats['pages_shared']:.0f} page aliases, "
              f"{stats['cow_copies']:.0f} copy-on-writes")
    if args.speculate:
        print(f"speculation: {stats['drafted_tokens']:.0f} tokens drafted, "
              f"{stats['accepted_tokens']:.0f} accepted "
              f"({stats['acceptance_rate']:.1%}), "
              f"{stats['generated_tokens'] / max(stats['decode_steps'], 1):.2f} "
              f"tokens/verify step")
    counts = stats["outcomes"]
    print("outcomes: " + " ".join(f"{k}={v}" for k, v in counts.items())
          + (f" (watchdog_fires={stats['watchdog_fires']:.0f})"
             if stats["watchdog_fires"] else ""))
    if 0 in out:
        print("generated (request 0):", out[0][:16])
    else:  # request 0 cancelled/timed out/shed/failed under a fault plan
        print("request 0 did not complete:",
              results[0].outcome.value, "—", results[0].reason)


if __name__ == "__main__":
    main()
