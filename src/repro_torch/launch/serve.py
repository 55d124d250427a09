"""Serving launcher of the port: batched prefill + greedy decode on the
contiguous cache, or continuous batching over a paged cache with
``--paged``, either one over a mesh of ranks with ``--mesh N | DxM |
PxDxM`` (counterpart of ``repro.launch.serve``). ``--autotune`` picks the decode's split count with
the planner of ``perf/autotune.py`` for the card's kernel, on both caches
(an explicit ``--num-splits`` wins).

On the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --batch 8 --prompt-len 512 --gen 32

Paged continuous batching (ragged synthetic requests through
``serving.ServingEngine``; ``--lazy``, ``--share-prefix``,
``--prefill-chunk``, ``--speculate``, ``--fault-plan`` as in JAX):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --paged --requests 16 --max-batch 8 --prompt-len 512 --gen 64

Serving over a mesh: ``--mesh`` takes JAX's forms, ``N`` the mesh
``("model",)``, ``DxM`` ``("data", "model")`` and ``PxDxM`` ``("pod",
"data", "model")``, one process a mesh position, spawned by the launcher
(``launch/mesh.py``). The weights are laid out by JAX's serving rules
(``ShardPlan.serving``: tensor parallel over ``model``, the vocab padded
to it), each rank drawing only its shard. The contiguous cache holds a
rank's batch rows (over ``pod`` and ``data``) and kv heads, or, where the
kv heads do not divide ``model``, its slots of every kv head
(``kv_cache_seq``: decode merges the ranks' attention partials); the page
pool is sharded over ``model`` and the engine's slots replicated over the
batch axes. The prefill runs under the prefill rules: a rank's ``S /
model`` rows of the residual stream where ``model`` divides S (the packed
paged prefill's row of ``prefill_len`` too), and attention's query rows
split over ``model`` where the rules set ``seq_full``; decode's one token
stays replicated. An FSDP config (``fsdp=True``: dbrx-132b,
llava-next-34b, qwen3-14b, deepseek-67b, deepseek-coder-33b) holds every
weight's ``embed`` dim over ``data`` too, as JAX's engine places it, and
gathers it at each use. The mesh line names the prefill's layout and the
weights held over ``data``.
``--dist-backend nccl`` (the default on cuda) needs a card a
rank; ranks that share one card need ``--dist-backend gloo``:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --mesh 2x2 --dist-backend gloo --batch 8 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --paged --mesh 2x2 --dist-backend gloo --requests 16 --max-batch 8

On the CPU, at smoke size (the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --smoke --device cpu --batch 2 --prompt-len 16 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --smoke --device cpu --paged --requests 4 --prompt-len 16 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --smoke --device cpu --mesh 2x2 --dist-backend gloo --batch 2 \\
      --prompt-len 16 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --smoke --device cpu --paged --mesh 2x2 --dist-backend gloo \\
      --requests 6 --prompt-len 16 --gen 4

The hybrid recurrentgemma-2b (RG-LRU and local-attention blocks) serves on
both caches and over ``--mesh`` (the RG-LRU on the rank's channels; its
one kv head takes the contiguous cache's ``kv_cache_seq`` branch on every
mesh); ``--share-prefix`` and ``--speculate`` exit with the engine's
refusal, as in JAX:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma_2b \\
      --smoke --device cpu [--paged [--mesh 2 --dist-backend gloo]]

falcon-mamba-7b (the ssm family, mixer-only Mamba blocks, no attention
layer) serves on both caches and over ``--mesh`` (the mixer on the rank's
channels); ``--share-prefix``, ``--speculate``
and ``--autotune`` exit with the engine's refusal:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon_mamba_7b \\
      --smoke --device cpu [--paged [--mesh 2 --dist-backend gloo]]

The MoE archs (deepseek-moe-16b, dbrx-132b) serve on every path, the
paged engine's modes and ``--mesh`` included (expert routing is stateless
per token):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek_moe_16b \\
      --smoke --device cpu [--paged [--mesh 2 --dist-backend gloo]]

The vlm llava-next-34b serves by tokens on every path, as in JAX (its
vision path, a prefill from patch embeddings, is ``greedy_generate``'s
``embeds=``); the encoder hubert-xlarge has no decode step and exits with
JAX's refusal:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llava_next_34b \\
      --smoke --device cpu [--paged [--mesh 2 --dist-backend gloo]]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.attention import IMPLS
from repro_torch.distributed.mesh import join_train_mesh
from repro_torch.distributed.parallel import layout_line
from repro_torch.launch import mesh as pool_mesh
from repro_torch.launch.train import parse_mesh
from repro_torch.runtime.steps import (ServeArtifacts, init_serve_params,
                                       make_serve_steps, serving_plan)
from repro_torch.serving.engine import no_attention_decode


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
                    vocab_size: int, *, feed: Optional[torch.Tensor] = None,
                    embeds: Optional[torch.Tensor] = None) -> Generation:
    """Prefill ``prompt [B, S]``, then ``gen - 1`` greedy decode steps.

    feed: optional [B, gen] tokens to feed to the decode steps in place of
    this run's own argmax (teacher forcing), so two impls can be compared
    step by step on one token stream; ``tokens`` stays this run's argmax.
    embeds: an arch with a frontend prefills from ``embeds [B, S,
    FRONTEND_DIM]`` in place of a prompt (pass ``prompt`` None); the
    decode steps take tokens.
    """
    first = prompt if embeds is None else embeds
    s = first.shape[1]
    caches = arts.cache_init_fn()
    _sync(first.device)
    t0 = time.perf_counter()
    logits, caches = arts.prefill_fn(params, prompt, caches, embeds=embeds)
    _sync(first.device)
    prefill_s = time.perf_counter() - t0
    out_logits = [logits]
    toks = [logits[:, :vocab_size].argmax(dim=-1)]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        tok = toks[-1] if feed is None else feed[:, i]
        logits, caches = arts.decode_fn(params, tok, caches, s + i)
        out_logits.append(logits)
        toks.append(logits[:, :vocab_size].argmax(dim=-1))
    _sync(first.device)
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
                    help="N, DxM or PxDxM: ranks over (model), (data, model) "
                         "or (pod, data, model), one process each; the "
                         "weights tensor-parallel over model, the page pool "
                         "sharded over it")
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
    ap.add_argument("--autotune", action="store_true",
                    help="pick --num-splits from the perf/autotune.py cost "
                         "model (persistent cache; explicit --num-splits "
                         "wins)")
    args = ap.parse_args(argv)

    cfg = (configs.smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    device = torch.device(args.device)
    try:
        shape = parse_mesh(args.mesh)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if args.autotune and "attn" not in cfg.block_pattern:
        raise SystemExit(no_attention_decode(cfg))
    if args.paged:
        return serve_paged(cfg, args, device, shape)

    max_len = args.prompt_len + args.gen
    num_splits = args.num_splits or 1
    if args.autotune and not args.num_splits:
        plan = autotuned_plan(cfg, args.batch, max_len, device)
        num_splits = plan.num_splits
        print(f"autotune: num_splits={plan.num_splits} "
              f"block_kv={plan.block_kv} ({plan.source}, "
              f"predicted {plan.time_s*1e6:.1f}us/layer)")
    if shape is None:
        res = _serve_contiguous(cfg, args, device, num_splits)[0]
    else:
        ranks, backend, devices = _spawn(_contiguous_rank, shape, args, device,
                                         (cfg, args, num_splits))
        r0 = ranks[0]
        _print_mesh(shape, backend, devices,
                    layout_line(cfg, shape, args.prompt_len, serve=True),
                    r0["sharded_embed"])
        for r, got in enumerate(ranks[1:], 1):
            if not np.array_equal(got["tokens"], r0["tokens"]):
                raise RuntimeError(f"rank {r} generated other tokens than "
                                   f"rank 0")
        res = Generation(torch.from_numpy(r0["tokens"]),
                         [torch.from_numpy(r0["first_logits"])],
                         r0["prefill_s"], r0["decode_s"])
    steps = args.gen - 1
    print(f"prefill: {args.batch}x{args.prompt_len} in {res.prefill_s*1e3:.1f}ms; "
          f"decode: {steps} steps in {res.decode_s*1e3:.1f}ms "
          f"({steps*args.batch/max(res.decode_s,1e-9):.1f} tok/s)")
    print("generated (first row):", res.tokens[0, :16].cpu().numpy())
    return res


def _serve_contiguous(cfg, args, device, num_splits: int, mesh=None):
    """Prefill and greedy decode of ``--batch`` random prompts on the
    contiguous cache, on one device or on this rank of ``mesh`` (its shard
    of the weights and the caches): ``(Generation, the ShardPlan or
    None)``."""
    arts = make_serve_steps(cfg, impl=args.impl,
                            max_len=args.prompt_len + args.gen,
                            batch=args.batch, num_splits=num_splits,
                            torch_chunk=min(1024, args.prompt_len),
                            device=device, mesh=mesh)
    params = arts.init_fn(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    return (greedy_generate(arts, params, prompt, args.gen, cfg.vocab_size),
            arts.plan)


def _share_cores(device, size: int) -> None:
    """Ranks on the CPU share its cores out."""
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))


def _contiguous_rank(pool, device, shape, cfg, args, num_splits):
    """One rank of ``--mesh`` on the contiguous cache: its tokens, first
    logits, times (numpy and floats, no tensors) and the leaves its plan
    holds over ``data``."""
    _share_cores(device, pool.size)
    res, plan = _serve_contiguous(cfg, args, device, num_splits,
                                  join_train_mesh(shape))
    return {"tokens": res.tokens.cpu().numpy(),
            "first_logits": res.logits[0].float().cpu().numpy(),
            "prefill_s": res.prefill_s, "decode_s": res.decode_s,
            "sharded_embed": list(plan.sharded_embed())}


def _spawn(fn, shape, args, device, fn_args):
    """Run ``fn`` on the ranks of ``shape``: (their results, the backend,
    their devices)."""
    size = int(np.prod(list(shape.values())))
    backend = args.dist_backend or pool_mesh.default_backend(device.type)
    ranks = pool_mesh.run_ranks(fn, size, (shape, *fn_args), backend=backend,
                                device_type=device.type)
    devices = [str(pool_mesh.rank_device(r, device.type)) for r in range(size)]
    return ranks, backend, devices


def weights_line(held) -> str:
    """The mesh line's note of the leaves a rank holds over ``data`` (an
    FSDP config's ``embed`` dims, rank 0's ``ShardPlan.sharded_embed``)."""
    if not held:
        return "weights: no dim over data"
    return (f"weights: the embed dims of {len(held)} leaves over data "
            f"(FSDP, gathered at each use): {', '.join(held)}")


def _print_mesh(shape, backend: str, devices, layout: str, held) -> None:
    axes = " x ".join(f"{a} {n}" for a, n in shape.items())
    where = ("on the pool axis" if list(shape) == ["model"]
             else f"over {axes} (the pool axis: model)")
    print(f"mesh: {len(devices)} ranks {where}, backend {backend}, devices "
          f"{', '.join(devices)}; prefill: {layout}; "
          f"{weights_line(held)}")


def autotuned_plan(cfg, batch: int, max_len: int, device):
    """``--autotune``'s plan for the contiguous cache's decode: the
    ``perf/autotune.py`` planner at every row's full reach, through the
    persistent cache, for ``device``'s kernel. A windowed arch keeps a ring
    of window slots, every one of them read once it is full."""
    from repro_torch.perf.autotune import (DecodeShape, device_name,
                                           plan_decode_persistent)
    shape = DecodeShape(batch=batch, hkv=cfg.num_kv_heads,
                        group=cfg.num_heads // cfg.num_kv_heads,
                        kv_len=min(max_len, cfg.attn_window or max_len),
                        head_dim=cfg.head_dim, dtype_bytes=cfg.dtype.itemsize)
    return plan_decode_persistent(shape, device=device_name(device))


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
    ``mesh``, a ``TrainMesh``) and serve the synthetic requests; returns
    ``(outputs, stats, engine)``."""
    from repro_torch.serving import ServingEngine

    plan = None if mesh is None else serving_plan(cfg, mesh, paged=True)
    params = init_serve_params(cfg, plan, seed=args.seed, device=device)
    pcfg, prefill_len = _paged_config(args, 1 if mesh is None
                                      else mesh.pool.size)
    try:
        eng = ServingEngine(cfg, pcfg, params, impl=args.impl, device=device,
                            mesh=mesh, prefill_len=prefill_len, lazy=args.lazy,
                            num_splits=args.num_splits or None,
                            autotune=args.autotune,
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


def _serve_rank(pool, device, shape, cfg, args):
    """One rank of ``--paged --mesh``: what rank 0 prints, from every rank
    (the parent checks that they agree), its decode split count and the
    leaves its plan holds over ``data``."""
    _share_cores(device, pool.size)
    out, stats, eng = _run_engine(cfg, args, device, join_train_mesh(shape))
    return (out, stats, eng.results, eng.num_splits,
            list(eng.plan.sharded_embed()))


def serve_paged(cfg, args, device, shape=None):
    """Continuous batching over ragged synthetic requests (paged KV cache),
    on one device or over the spawned ranks of the mesh ``shape``; prints
    JAX's summary lines and returns ``(outputs, stats, engine)``, or
    ``(outputs, stats, per-rank (outputs, stats, results))`` under a mesh
    (rank 0's outputs and stats, equal on every rank)."""
    plan = _fault_plan(args)
    if plan is not None:
        print(f"fault plan (seed {plan.seed}): "
              + " ".join(f"{e.kind}@{e.step}" for e in plan.events))
    if shape:
        ranks, backend, devices = _spawn(_serve_rank, shape, args, device,
                                         (cfg, args))
        prefill_len = _paged_config(args, shape["model"])[1]
        out, stats, results, splits, held = ranks[0]
        _print_mesh(shape, backend, devices,
                    layout_line(cfg, shape, prefill_len, serve=True)
                    + f" (packed rows of {prefill_len})", held)
        for r, (o, st, _, ns, _) in enumerate(ranks[1:], 1):
            same = set(o) == set(out) and all(np.array_equal(o[k], out[k])
                                              for k in out)
            if not same or st != stats or ns != splits:
                raise RuntimeError(f"rank {r} served other outputs, stats or "
                                   f"split counts than rank 0")
        _print_splits(args, splits)
        _print_summary(args, out, stats, results)
        return out, stats, ranks
    out, stats, eng = _run_engine(cfg, args, device)
    _print_splits(args, eng.num_splits)
    _print_summary(args, out, stats, eng.results)
    return out, stats, eng


def _print_splits(args, num_splits: int) -> None:
    """JAX's line naming the decode split count, when one was asked for."""
    if args.autotune or args.num_splits:
        print(f"decode num_splits: {num_splits}"
              + (" (autotuned)" if args.autotune and not args.num_splits
                 else ""))


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
