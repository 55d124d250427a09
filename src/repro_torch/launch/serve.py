"""Serving launcher of the port: batched prefill + greedy decode on the
contiguous cache, or continuous batching over a paged cache with
``--paged`` (counterpart of ``repro.launch.serve`` without ``--mesh`` and
``--autotune``).

On the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --batch 8 --prompt-len 512 --gen 32

Paged continuous batching (ragged synthetic requests through
``serving.ServingEngine``; ``--lazy``, ``--share-prefix``,
``--prefill-chunk``, ``--speculate``, ``--fault-plan`` as in JAX):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --paged --requests 16 --max-batch 8 --prompt-len 512 --gen 64

On the CPU, at smoke size (the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --smoke --device cpu --batch 2 --prompt-len 16 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --smoke --device cpu --paged --requests 4 --prompt-len 16 --gen 4
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
    if args.paged:
        return serve_paged(cfg, args, device)

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


def serve_paged(cfg, args, device):
    """Continuous batching over ragged synthetic requests (paged KV cache);
    prints JAX's summary lines and returns ``(outputs, stats, engine)``."""
    from repro_torch.serving import FaultPlan, PagedCacheConfig, ServingEngine

    params = lm.init_params(cfg, seed=args.seed, device=device)
    rs = np.random.RandomState(args.seed)
    budget = args.prompt_len + args.gen
    # pool sized so roughly half the requests fit at once: the scheduler has
    # to evict and admit, which is the scenario being served
    pages_per_seq = -(-budget // args.page_size) + 1
    num_pages = args.num_pages or (1 + max(2, args.requests // 2) * pages_per_seq)
    pcfg = PagedCacheConfig(page_size=args.page_size, max_batch=args.max_batch,
                            max_pages_per_seq=pages_per_seq,
                            num_pages=num_pages)
    # lazy: a preempted row re-prefills prompt + generated, so a prefill row
    # must hold a full budget
    prefill_len = max(args.prompt_len, args.page_size)
    if args.lazy:
        prefill_len = max(prefill_len, budget)
    plan = FaultPlan(seed=args.fault_plan) if args.fault_plan >= 0 else None
    eng = ServingEngine(cfg, pcfg, params, impl=args.impl, device=device,
                        prefill_len=prefill_len, lazy=args.lazy,
                        num_splits=args.num_splits or None,
                        share_prefix=args.share_prefix,
                        prefill_chunk=args.prefill_chunk or None,
                        speculate_k=args.speculate or None,
                        deadline_ms=args.deadline_ms or None,
                        max_queue=args.max_queue or None,
                        fault_plan=plan)
    if plan is not None:
        print(f"fault plan (seed {plan.seed}): "
              + " ".join(f"{e.kind}@{e.step}" for e in plan.events))
    if args.num_splits:
        print(f"decode num_splits: {eng.num_splits}")
    out, stats = eng.run(paged_requests(cfg, pcfg, args, rs))
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
              eng.results[0].outcome.value, "—", eng.results[0].reason)
    return out, stats, eng


if __name__ == "__main__":
    main()
