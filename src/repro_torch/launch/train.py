"""Training launcher of the port (counterpart of ``repro.launch.train``
without ``--mesh``): one device.

On the card (the default device), granite-3-2b at full width and depth:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
      --steps 4 --batch 4 --seq 2048 --ckpt-every 1000

recurrentgemma-2b at full width and depth, past its 2048-token window (the
attention kernels at head dim 256):
  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma_2b \\
      --steps 4 --batch 1 --seq 3072 --ckpt-every 1000

deepseek-moe-16b at full width (the router f32 in any dtype; ``moe_aux``
joins the loss at weight 0.01 and the log line), as on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_moe_16b \\
      --smoke --device cpu --steps 3 --batch 2 --seq 32

AdamW keeps an f32 master copy of bf16 params only: the copy of f32 params
would be the params themselves (the same update, 4 bytes a parameter
more; recurrentgemma-2b's 3.55 B f32 params, grads and moments already
fill 56.8 GB of the card's 80).

On the CPU, at smoke size (the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
      --smoke --device cpu --steps 3 --batch 2 --seq 32

A run resumes from the newest checkpoint in ``--ckpt-dir`` (by default a
directory under the system temp dir); give a fresh directory to start over.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch.core.attention import IMPLS
from repro_torch.data import DataConfig
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    """Parse arguments, build the step and the trainer, train, and return
    the trainer's result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--impl", default="kernel", choices=IMPLS)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)

    try:
        cfg = (configs.smoke_config(args.arch) if args.smoke
               else configs.get_config(args.arch))
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    cfg = dataclasses.replace(cfg, dtype=getattr(torch, args.dtype))
    arts = make_train_step(cfg, opt=AdamWConfig(
                               lr=args.lr, keep_master=cfg.dtype != torch.float32),
                           impl=args.impl,
                           total_steps=args.steps, warmup_steps=args.warmup,
                           microbatch=args.microbatch,
                           torch_chunk=min(1024, args.seq),
                           device=torch.device(args.device))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, frontend=cfg.frontend)
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    result = Trainer(arts=arts, data_cfg=data_cfg, tcfg=tcfg).run(args.steps)
    print(f"done at step {result['stop_step']} "
          f"(preempted={result['preempted']}, "
          f"stragglers={len(result['stragglers'])})")
    return result


if __name__ == "__main__":
    main()
