"""Training launcher of the port (counterpart of ``repro.launch.train``):
one device, or a mesh of ranks with ``--mesh``.

``--mesh`` takes JAX's forms: ``N`` is the mesh ``("model",)``, ``DxM``
``("data", "model")`` and ``PxDxM`` ``("pod", "data", "model")``: one
process a mesh position (``launch.mesh.run_ranks``), the data and pod axes
data-parallel, the model axis tensor-parallel and sequence-parallel (a
rank's ``seq / model`` rows of the residual stream between blocks where
``model`` divides ``--seq``; attention's query rows split over it too
under ``seq_full``: a config with ``ctx_parallel_attn`` whose heads it
does not divide), the config's FSDP settings as JAX's rules take them
(``distributed/sharding.py``). The mesh line names the layout, e.g.
``seq over model 4; attention's query rows over model 4``. ``--dist-backend``:
``nccl`` (the default on cuda) needs a card a rank; ranks that share a card,
or run on the CPU, take ``gloo``. Every arch trains on a mesh: the hybrid's
RG-LRU and the ssm's Mamba mixer on the rank's channels, the MoE's experts
split over the model axis. On the CPU, four ranks at smoke size (any
arch):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
      --smoke --device cpu --mesh 2x2 --dist-backend gloo --steps 3 \\
      --batch 4 --seq 32
and on the card, four ranks sharing it (``chip_smoke.py`` phase 5g trains
granite-3-2b so at full width and 1 of its 40 layers):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
      --smoke --mesh 2x2 --dist-backend gloo --steps 3 --batch 4 --seq 256

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

The frontend archs train from the stub frontends' embeddings
(``DataConfig(frontend=...)``: ``embeds`` [B, S, 1024] and labels):
hubert-xlarge (the encoder: per-position loss, non-causal attention at head
dim 80) at full size, and llava-next-34b (the vlm) the same way:
  PYTHONPATH=src python -m repro_torch.launch.train --arch hubert_xlarge \\
      --steps 3 --batch 8 --seq 1024 --ckpt-every 1000
  PYTHONPATH=src python -m repro_torch.launch.train --arch hubert_xlarge \\
      --smoke --device cpu --steps 3

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
from repro_torch.distributed.mesh import join_train_mesh
from repro_torch.distributed.parallel import layout_line
from repro_torch.launch.mesh import BACKENDS, default_backend, run_ranks
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.trainer import Trainer, TrainerConfig

#: the axes of ``--mesh`` by its number of dims (JAX's ``parse_mesh``)
MESH_FORMS = {1: ("model",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def parse_mesh(s: str):
    """``"16x16"`` → ``{"data": 16, "model": 16}`` (None for ``""``)."""
    if not s:
        return None
    try:
        dims = [int(x) for x in s.split("x")]
    except ValueError:
        raise ValueError(f"--mesh {s!r}: dims are integers joined by 'x'")
    if len(dims) not in MESH_FORMS or min(dims) < 1:
        raise ValueError(f"--mesh {s!r}: N, DxM or PxDxM of positive sizes")
    return dict(zip(MESH_FORMS[len(dims)], dims))


def _config(args):
    cfg = (configs.smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    return dataclasses.replace(cfg, dtype=getattr(torch, args.dtype))


def _train(args, device, mesh=None):
    """Build the step and the trainer of ``args`` and train."""
    cfg = _config(args)
    arts = make_train_step(cfg, mesh=mesh, opt=AdamWConfig(
                               lr=args.lr, keep_master=cfg.dtype != torch.float32),
                           impl=args.impl,
                           total_steps=args.steps, warmup_steps=args.warmup,
                           microbatch=args.microbatch,
                           torch_chunk=min(1024, args.seq), device=device)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, frontend=cfg.frontend)
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    trainer = Trainer(arts=arts, data_cfg=data_cfg, tcfg=tcfg,
                      batch_shardings=(arts.shardings or {}).get("batch"))
    return trainer, trainer.run(args.steps)


def _rank(pool, device, shape, args):
    """One rank of a ``--mesh`` run: its summary (no tensors). Ranks on the
    CPU share its cores out."""
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // pool.size))
    trainer, result = _train(args, device, join_train_mesh(shape))
    return {"stop_step": result["stop_step"], "preempted": result["preempted"],
            "stragglers": result["stragglers"],
            "losses": [m["loss"] for m in trainer.metrics_log]}


def main(argv=None):
    """Parse arguments, build the step and the trainer, train, and return
    the trainer's result (with ``--mesh``: rank 0's, without tensors, plus
    ``"ranks"``: every rank's)."""
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
                         "plain versions); with --mesh, cuda or cpu")
    ap.add_argument("--mesh", default="",
                    help="N, DxM or PxDxM: ranks over (model), (data, model) "
                         "or (pod, data, model)")
    ap.add_argument("--dist-backend", default=None, choices=BACKENDS,
                    help="the ranks' backend (default nccl on cuda, gloo on "
                         "cpu; ranks sharing a card need gloo)")
    args = ap.parse_args(argv)

    shape = parse_mesh(args.mesh)
    if shape is None:
        result = _train(args, torch.device(args.device))[1]
    else:
        device_type = torch.device(args.device).type
        size = 1
        for n in shape.values():
            size *= n
        print(f"mesh: {size} ranks over "
              f"{' x '.join(f'{a} {n}' for a, n in shape.items())} "
              f"({args.dist_backend or default_backend(device_type)}, "
              f"{device_type}); {layout_line(_config(args), shape, args.seq)}",
              flush=True)
        ranks = run_ranks(_rank, size, (shape, args),
                          backend=args.dist_backend, device_type=device_type)
        result = dict(ranks[0], ranks=ranks)
    print(f"done at step {result['stop_step']} "
          f"(preempted={result['preempted']}, "
          f"stragglers={len(result['stragglers'])})")
    return result


if __name__ == "__main__":
    main()
