"""Serving launcher of the port: batched prefill + greedy decode on the
contiguous cache (counterpart of ``repro.launch.serve`` without ``--paged``,
``--mesh`` and ``--autotune``).

On the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --batch 8 --prompt-len 512 --gen 32

On the CPU, at smoke size (the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --smoke --device cpu --batch 2 --prompt-len 16 --gen 4
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

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


if __name__ == "__main__":
    main()
