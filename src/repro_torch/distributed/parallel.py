"""Training over a mesh: how one rank holds and runs its shard of the model
(what the JAX package leaves to GSPMD under ``make_train_step(mesh=)``).

:class:`NamedSharding` is a spec on a :class:`~repro_torch.distributed.mesh.TrainMesh`
(JAX's ``NamedSharding``): which part of a full tensor this rank holds
(:meth:`~NamedSharding.shard`) and how to rebuild the full tensor from
every rank's part (:meth:`~NamedSharding.gather`, a collective).

:class:`ShardPlan` carries the specs of ``distributed.sharding`` out in
the layers of every family:

* **sequence parallel over ``model``** (the rules' ``seq``): between the
  blocks a rank holds rows ``[r·S/m, (r+1)·S/m)`` of the residual stream
  (m the ``model`` axis's size, r the rank's place on it); the norms and
  the residual adds run on those rows. :meth:`ShardPlan.seq_rows` decides
  it per forward from S, as JAX's ``spec_for`` does: where m does not
  divide S (a decode step's one token, say) the stream stays replicated.
  Work split over ``model`` is entered by an all-gather along the
  sequence (its gradient a reduce-scatter) and left by a reduce-scatter
  along it (its gradient an all-gather), Megatron's sequence-parallel
  pair, in place of the all-reduce pair below; work that is not split
  and reads every row (a sequence mixer on replicated channels) gathers
  the rows and keeps its own; per-token work that is not split (an MLP
  whose FFN ``model`` does not divide) runs on the rank's rows.
* **context parallel over ``model``** (the rules' ``seq_full``, set where
  ``cfg.ctx_parallel_attn`` holds and the q heads do not divide ``model``;
  every such config is causal): attention computes every head for the
  rank's query rows ``[a, b)`` against K/V over the gathered sequence, cut
  to ``[0, b)`` so that q is their suffix and the causal mask, the window,
  the segment ids and the dropout hash see global positions (no kernel
  change); RoPE takes the rows' global positions; ``wo`` gives the rank's
  own residual rows with no sum over ``model``. A query shard's dK/dV are
  partial and summed over ``model`` by the gather's reduce-scatter.
* **tensor parallel over ``model``** (heads, kv heads, mlp, rnn and vocab
  dims sharded): ``wq/wk/wv`` column-parallel on the rank's heads, ``wo``
  row-parallel; the MLP the same way; the recurrent mixers (the RG-LRU,
  Mamba) on the rank's channels over the whole sequence, their
  in-projections column-parallel, their out-projections row-parallel, the
  projections out of the channels into a replicated tensor (the RG-LRU's
  gates, Mamba's ``w_bc`` and ``w_dt1``) summed over ``model``; the
  embedding looked up on the rank's vocab rows (the others give zeros)
  and summed (reduce-scattered to the rank's rows under ``seq``);
  ``lm_head`` column-parallel on the gathered rows with a vocab-parallel
  cross-entropy (a global max and sum-exp over ``model``, padded columns
  masked). Without ``seq`` split work is entered by ``copy_to`` and left
  by ``reduce_from`` (Megatron's f / g).
* an ``[a | b]`` leaf (the gated MLP's ``wi``, the shared experts' ``wi``,
  Mamba's ``in_proj``) splits half by half, so every rank holds the same
  slice of both halves (:meth:`ShardPlan.block`).
* **expert parallel over ``model``** (``experts`` sharded): the router's
  columns are the rank's experts, its logits gathered over ``model``
  before the softmax, so every model rank routes alike; a rank runs its
  experts on the dispatched tokens and the combined output is summed over
  ``model`` (reduce-scattered along the sequence under ``seq``, whose
  tokens are gathered before dispatch, so the groups and the capacity are
  the single-device ones). The tokens' groups are the global microbatch's:
  a rank routes its own groups where they divide the batch axes
  (``moe_groups``), and every group where one spans ranks (JAX's fallback
  replicates them), its tokens gathered over the batch axes.
* kv heads that ``model`` does not divide, under heads that it does: the
  rules replicate ``wk/wv``, and each rank projects the kv heads its own
  q heads read (``global q head // group``), expanding them to one a q
  head where the group does not split evenly.
* a weight whose ``embed`` dim is sharded (over ``data`` with
  ``cfg.fsdp``, over (data, model) in the FSDP profile) is gathered before
  use; its gradient comes back summed over those ranks and scattered.
* weights replicated over ``model`` but used on the rank's heads only
  (``q_norm``/``k_norm``, replicated ``wk/wv``) enter through
  ``collectives.copy_to``, so their gradients are whole on every rank.
  Every other leaf replicated over ``model`` has, under ``seq``, a partial
  gradient (its work saw the rank's rows, or was cut to them): the norms,
  ``final_norm``, the attention weights under ``seq_full``, the leaves of
  work that ``model`` does not split. :meth:`ShardPlan.reduce_grads` sums
  those over ``model`` as well as over the batch axes.
* the batch: a rank holds rows ``[i·b, (i+1)·b)`` of every microbatch (i
  its position along the batch axes), and passes ``i·b`` and its first q
  head to the attention kernels (``batch_offset``, ``head_offset``) so
  dropout draws the single-device masks. The loss is the global weighted
  mean: each rank's weighted sum over the global weight sum, whose
  gradients :meth:`ShardPlan.reduce_grads` sums over the batch axes a
  leaf is not sharded over.

A leaf is keyed by its name in a block, and a mixer's leaves also by the
block's kind (``rec:mixer.wo``, ``attn:mixer.wo``): the hybrid's two
``wo`` leaves have other specs. A spec the plan cannot carry out raises a
``ValueError`` naming the leaf and its spec.

Serving (:meth:`ShardPlan.serving`, what ``repro.runtime.steps``'s
``make_serve_steps(mesh=)`` leaves to GSPMD): JAX runs prefill under
``default_rules(serve=True)`` and decode under ``decode=True``. The weights
are held once, as the prefill rules lay them out: tensor parallel over
``model`` and, for an FSDP config (``cfg.fsdp``), every ``embed`` dim over
``data`` as well, a rank holding its ``1 / data`` share of it. That is
where JAX's ``ServingEngine`` puts them (``tree_shardings`` under the
prefill rules) and where its decode step, which has no weight shardings of
its own, takes them from; the rules of the two steps differ in nothing else
a weight has. So prefill and decode both gather a sharded ``embed`` dim at
each use (:meth:`ShardPlan.weight`), as GSPMD gathers it inside JAX's
steps. The prefill runs under the prefill rules'
``seq`` and ``seq_full`` (a packed paged prefill ``[1, T, d]`` splits its
T rows where ``model`` divides T); decode's one token falls back to
replicated. The caches follow the rules too: batch
rows over the batch axes (replicated, as ``spec_for`` falls back, where
they do not divide the batch), kv heads over ``model`` where they divide it,
else the contiguous cache's sequence over ``model`` (``kv_cache_seq``,
:attr:`ShardPlan.kv_seq`: decode replicates q, every rank attends over its
slots and the partials merge across ``model``), the recurrent state on
the rank's ``rnn`` channels. A page pool is sharded over ``model`` by
pages whatever the heads (``distributed/paged.py``), and the paged
engine's slots are replicated over the batch axes (``batch`` None), as
the ``P()`` specs of JAX's ``shard_map`` replicate them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.online_softmax import NEG_INF
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import default_rules

_UNSET = object()

#: gradients all-reduced at once (elements), a bucket
BUCKET = 1 << 26


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``spec`` on ``mesh``: entry ``d`` names the axes dim ``d`` is split
    over (missing trailing entries: replicated). ``block[d]``, where given,
    cuts dim ``d`` into blocks of that many elements, each split on its
    own (``collectives``)."""
    mesh: Any
    spec: tuple
    block: tuple = ()

    def _dims(self):
        for d, entry in enumerate(self.spec):
            if entry is not None and self.mesh.size(entry) > 1:
                yield d, entry, (self.block[d] if d < len(self.block) else None)

    def shard(self, x):
        """This rank's part of the full ``x`` (numpy or torch)."""
        for d, entry, block in self._dims():
            x = C.shard(x, d, self.mesh, entry, block)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's part (a collective: every rank
        calls it)."""
        for d, entry, block in self._dims():
            x = C.gather_nograd(x, d, self.mesh, entry, block)
        return x

    def global_shape(self, local_shape) -> Tuple[int, ...]:
        shape = list(local_shape)
        for d, entry, _ in self._dims():
            shape[d] *= self.mesh.size(entry)
        return tuple(shape)


def _layer_key(name: str, kinds) -> str:
    """``blocks.3.mlp.wi`` → ``mlp.wi``; a mixer's leaf with its block's
    kind (``kinds[i]``), ``blocks.3.mixer.wo`` → ``rec:mixer.wo``;
    top-level names as they are."""
    parts = name.split(".", 2)
    if parts[0] != "blocks":
        return name
    key = parts[2]
    return f"{kinds[int(parts[1])]}:{key}" if key.startswith("mixer.") else key


#: the leaves of each recurrent mixer that carry its ``rnn`` channels: all
#: of them split over ``model`` on their first ``rnn`` dim, or none
_RNN_LEAVES = {
    "rec": ("wx", "wg", "wo", "conv", "w_inp", "w_rec", "lambda"),
    "ssm": ("in_proj", "conv", "w_bc", "w_dt1", "w_dt2", "dt_bias", "A_log",
            "D", "out_proj"),
}


class ShardPlan:
    """One rank's plan for its shard of ``cfg`` on ``mesh`` under ``rules``
    (``specs``/``logical``: port parameter name → spec / logical axes).

    Flags, each for the blocks that have the leaf: ``heads``/``kv`` (the
    attention's q / kv heads split over ``model``), ``rnn`` (the recurrent
    mixer's channels), ``experts``; ``vocab``; ``seq`` (the residual
    stream's sequence over ``model`` between the blocks, where
    :meth:`seq_rows` finds that ``model`` divides it) and ``ctx``
    (attention's query rows over ``model`` under ``seq``); ``kv_seq``
    (serving: the contiguous cache's sequence over ``model``,
    :meth:`serving`). ``batch``: the batch axes' entry, the rules' unless
    given (the paged engine's None). ``rows_log``: None, or a list to
    which every forward appends ``("residual", rows)`` at each block's
    input and attention ``("query", rows)`` (the layout a rank ran)."""

    def __init__(self, cfg, mesh, rules, specs: Dict[str, tuple],
                 logical: Dict[str, tuple], *, batch=_UNSET):
        self.cfg, self.mesh, self.specs = cfg, mesh, specs
        period = len(cfg.block_pattern)
        self.kinds = [cfg.block_pattern[i % period] for i in range(cfg.num_layers)]
        self._spec, self._logical = {}, {}
        for n, spec in specs.items():
            key = _layer_key(n, self.kinds)
            if self._spec.setdefault(key, spec) != spec:
                raise ValueError(f"{cfg.name}: {n} has spec {spec}, another "
                                 f"{key} {self._spec[key]}")
            self._logical[key] = logical[n]
        if batch is _UNSET:
            self.batch = rules.rules["batch"]
            if rules.rules.get("moe_groups") != self.batch:
                raise ValueError(f"{cfg.name}: moe_groups over "
                                 f"{rules.rules.get('moe_groups')}, the batch "
                                 f"over {self.batch}")
        else:
            self.batch = batch
        self.rows_log = None
        self.vocab = self._spec["embed"][0] == "model"
        self.heads = self.splits("attn:mixer.wq", 1)
        self.kv = self.splits("attn:mixer.wk", 1)
        self.rnn = False
        for kind, leaves in _RNN_LEAVES.items():
            split = {leaf: self._rnn_split(f"{kind}:mixer.{leaf}")
                     for leaf in leaves if f"{kind}:mixer.{leaf}" in self._spec}
            if len(set(split.values())) > 1:
                raise ValueError(
                    f"{cfg.name}: the {kind} mixer's channels split over model "
                    f"in some leaves, not in others: " + ", ".join(
                        f"mixer.{leaf} {self._spec[f'{kind}:mixer.{leaf}']}"
                        for leaf in split))
            self.rnn = self.rnn or any(split.values())
        self.experts = self.splits("mlp.router", 1)
        if cfg.moe is not None:
            for key in ("mlp.wi", "mlp.wo"):
                if self.splits(key, 0) != self.experts:
                    raise ValueError(f"{cfg.name}: {key} {self._spec[key]} "
                                     f"against mlp.router "
                                     f"{self._spec['mlp.router']}")
        e = cfg.moe.num_experts if cfg.moe is not None else 0
        self.experts_local = e // mesh.size("model") if self.experts else e
        self.expert_offset = (mesh.index("model") * self.experts_local
                              if self.experts else 0)
        self._halves = {}            # an [a | b] leaf's half, split on its own
        if cfg.moe is None and cfg.mlp_type == "gated_silu":
            self._halves["mlp.wi"] = cfg.d_ff
        if cfg.moe is not None and cfg.moe.num_shared_experts:
            self._halves["mlp.shared.wi"] = (cfg.moe.num_shared_experts
                                             * cfg.moe.d_ff_expert)
        if cfg.mamba is not None:
            self._halves["ssm:mixer.in_proj"] = cfg.mamba.d_inner
        for key, half in list(self._halves.items()):
            if key not in self._spec:
                del self._halves[key]
                continue
            entry = self._spec[key][1]
            if entry is not None and half % self.mesh.size(entry):
                raise ValueError(f"{cfg.name}: {key} {self._spec[key]}: its "
                                 f"halves of {half} do not split over "
                                 f"{entry}={self.mesh.size(entry)}")
        self.hq_local = self.head_offset = 0
        self.kv_cols = None      # wk/wv columns this rank projects, if sliced
        self.kv_index = None     # the kv heads those columns are
        self.partial = set()     # replicated over model, used on local heads
        self.kv_seq = False      # serving: the cache's sequence over model
        if "attn:mixer.wq" in self._spec:
            self._plan_heads(cfg, mesh)
        self._plan_seq(rules)

    @classmethod
    def serving(cls, cfg, mesh, shapes: Dict[str, tuple],
                logical: Dict[str, tuple], *, paged: bool = False,
                rows: Optional[int] = None):
        """The plan of serving ``cfg`` on ``mesh`` (module docstring):
        ``shapes`` the full parameters' shapes (vocab padded), ``logical``
        their logical axes. The weights take the prefill rules' specs; a
        leaf the decode rules lay out otherwise must differ only in its
        ``embed`` dims. ``paged``: the slots are replicated over the batch
        axes; ``rows``: the contiguous batch, replicated over the batch
        axes where they do not divide it."""
        prefill = default_rules(mesh, cfg, serve=True)
        decode = default_rules(mesh, cfg, serve=True, decode=True)
        specs = prefill.tree_specs(shapes, logical)
        for n, spec in decode.tree_specs(shapes, logical).items():
            for d, (a, b) in enumerate(zip(specs[n], spec)):
                if a != b and logical[n][d] != "embed":
                    raise ValueError(f"{cfg.name}: {n} is {specs[n]} under "
                                     f"the prefill rules, {spec} under the "
                                     f"decode rules")
        batch = decode.rules["batch"]
        if paged or (rows is not None and rows % mesh.size(batch)):
            batch = None
        plan = cls(cfg, mesh, decode, specs, logical, batch=batch)
        plan._plan_seq(prefill)
        plan.shapes = dict(shapes)
        plan.kv_seq = ("attn:mixer.wq" in plan._spec and not plan.kv
                       and mesh.size("model") > 1)
        return plan

    def sharded_embed(self) -> Dict[str, tuple]:
        """The leaves (by key, as ``mlp.wi``) whose ``embed`` dims are
        sharded (over ``data`` under FSDP): key → the entries of those
        dims. Each is gathered at every use."""
        out = {}
        for key, spec in self._spec.items():
            got = tuple(spec[d] for d, name in enumerate(self._logical[key])
                        if name == "embed" and spec[d] is not None
                        and self.mesh.size(spec[d]) > 1)
            if got:
                out[key] = got
        return out

    def _plan_seq(self, rules) -> None:
        """``seq`` and ``ctx`` from ``rules``' ``seq`` / ``seq_full``."""
        cfg = self.cfg
        tp = self.mesh.size("model") > 1
        self.seq = tp and rules.rules.get("seq") == "model"
        self.ctx = (self.seq and rules.rules.get("seq_full") == "model"
                    and "attn:mixer.wq" in self._spec)
        if self.seq and not self.vocab:
            raise ValueError(f"{cfg.name}: seq over model with the vocab "
                             f"replicated (embed {self._spec['embed']}): the "
                             f"plan's head is vocab-parallel")
        if self.ctx and (self.heads or not cfg.causal):
            raise ValueError(f"{cfg.name}: seq_full over model with the heads "
                             f"split ({self.heads}) or non-causal attention "
                             f"(causal {cfg.causal})")

    def seq_rows(self, s: int) -> bool:
        """Whether a forward over ``s`` positions lays its residual stream
        out over ``model`` (``seq``): JAX's ``spec_for`` replicates a dim
        its axis does not divide, so ``s`` a multiple of ``model``'s
        size."""
        return self.seq and s % self.mesh.size("model") == 0

    def _plan_heads(self, cfg, mesh) -> None:
        hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        m = mesh.size("model") if self.heads else 1
        self.hq_local = hq // m
        self.head_offset = mesh.index("model") * self.hq_local if self.heads else 0
        if not self.heads:
            return
        if cfg.qk_norm:
            self.partial |= {"attn:mixer.q_norm", "attn:mixer.k_norm"}
        if not self.kv:
            self.partial |= {"attn:mixer.wk", "attn:mixer.wv"}
            group = hq // hkv
            idx = [(self.head_offset + i) // group for i in range(self.hq_local)]
            uniq = sorted(set(idx))
            g = self.hq_local // len(uniq)
            if g * len(uniq) != self.hq_local or \
                    idx != [uniq[i // g] for i in range(self.hq_local)]:
                uniq = idx             # one kv head a q head
            self.kv_cols = torch.cat([torch.arange(h * hd, (h + 1) * hd)
                                      for h in uniq])
            self.kv_index = torch.tensor(uniq)

    def splits(self, key: str, dim: int) -> bool:
        """Whether leaf ``key`` exists and splits dim ``dim`` over
        ``model`` alone (tensor or expert parallel; FSDP's joint entries
        are gathered, not split)."""
        return key in self._spec and self._spec[key][dim] == "model"

    def _rnn_split(self, key: str) -> bool:
        logical = self._logical[key]
        return self._spec[key][logical.index("rnn")] == "model"

    # -- sharding objects --------------------------------------------------
    def block(self, name: str) -> tuple:
        """Per-dim blocks of a parameter: an ``[a | b]`` leaf's columns
        (the gated MLPs' ``wi``, Mamba's ``in_proj``) are two halves, each
        split on its own."""
        half = self._halves.get(_layer_key(name, self.kinds))
        return () if half is None else (None, half)

    def sharding(self, name: str) -> NamedSharding:
        return NamedSharding(self.mesh, self.specs[name], self.block(name))

    # -- weights -----------------------------------------------------------
    def weight(self, w: torch.Tensor, key: str) -> torch.Tensor:
        """The weight ``w`` (parameter ``key``, as ``attn:mixer.wq``,
        ``mlp.wi`` or ``embed``) as the layer computes with it: its sharded
        ``embed`` dims gathered, and entered through ``copy_to`` over
        ``model`` where its gradient would otherwise be partial."""
        spec, logical = self._spec[key], self._logical[key]
        for d, name in enumerate(logical):
            if name == "embed" and spec[d] is not None:
                w = C.gather(w, d, self.mesh, spec[d])
        if key in self.partial:
            w = C.copy_to(w, self.mesh, "model")
        return w

    def kv_weight(self, w: torch.Tensor, key: str) -> torch.Tensor:
        """``wk``/``wv`` for this rank's q heads: sharded, or the replicated
        weight's columns of the kv heads its q heads read."""
        w = self.weight(w, key)
        return w if self.kv_cols is None else w[:, self.kv_cols.to(w.device)]

    @torch.no_grad()
    def place(self, params):
        """Serving: every full leaf of ``params`` (a model as one device
        holds it) replaced by this rank's shard, in place; a leaf already
        at its shard's shape stays. Returns ``params``."""
        from repro_torch.models.lm import set_param
        for n, p in list(params.named_parameters()):
            sh = self.sharding(n)
            if tuple(p.shape) == tuple(self.shapes[n]) and \
                    sh.global_shape(p.shape) != tuple(p.shape):
                set_param(params, n, sh.shard(p.detach()).contiguous().clone())
        return params

    # -- activations -------------------------------------------------------
    def gather_model(self, x):
        """Every ``model`` rank's part of the last dim of ``x`` (serving:
        q or k/v of every head from the rank's heads; no gradient)."""
        return C.gather_nograd(x, x.dim() - 1, self.mesh, "model")

    def own_heads(self, o):
        """``o [..., Hq·D]`` of every head → this rank's heads' columns
        where the heads are split (``wo`` row-parallel on them)."""
        if not self.heads:
            return o
        hd = self.cfg.head_dim
        return o[..., self.head_offset * hd:(self.head_offset + self.hq_local) * hd]

    def kv_heads_of(self, t):
        """``t [B, Hkv, S, D]`` of every kv head → the kv heads this rank's
        q heads read (one a q head where the group does not split evenly)."""
        if not self.heads:
            return t
        if self.kv:
            n = self.cfg.num_kv_heads // self.mesh.size("model")
            i = self.mesh.index("model") * n
            return t[:, i:i + n]
        return t.index_select(1, self.kv_index.to(t.device))

    def batch_part(self, x):
        """This rank's rows of a global batch ``x`` [B, ...] (serving)."""
        n = self.mesh.size(self.batch)
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"over the {n} ranks of the batch axes "
                             f"{self.batch}")
        return self.own_rows(x, x.shape[0] // n)

    def gather_logits(self, logits):
        """This rank's logits [b, ..., V / model] → the global batch's of
        every vocab column (serving; no gradient), equal on every rank."""
        if self.vocab:
            logits = self.gather_model(logits)
        return C.gather_nograd(logits, 0, self.mesh, self.batch)

    def kv_shards(self, cap: int) -> int:
        """The shards of a contiguous cache of ``cap`` slots along its
        sequence: ``model``'s size under ``kv_seq`` where it divides
        ``cap``, else 1 (replicated, as the rules fall back)."""
        m = self.mesh.size("model")
        return m if self.kv_seq and cap % m == 0 else 1

    def enter(self, x, split: bool, seq: bool = False):
        """An activation ``x [b, S, ...]`` entering work split over
        ``model`` (``split``) or, under ``seq`` (``x`` the rank's rows),
        work that reads every row: the rows gathered over ``model`` (the
        gradient reduce-scattered back to the rank's), else the
        replicated activation entered by ``copy_to``."""
        if seq:
            return self.gather_seq(x)
        return C.copy_to(x, self.mesh, "model") if split else x

    def leave(self, x, split: bool, seq: bool = False):
        """Results of :meth:`enter`'s work: under ``seq`` the rank's rows
        of them, reduce-scattered over ``model`` where the work was split
        (partial sums), cut where it was not; else the partial results of
        split work summed over ``model``."""
        if seq:
            return (C.reduce_scatter(x, 1, self.mesh, "model") if split
                    else self.seq_part(x))
        return C.reduce_from(x, self.mesh, "model") if split else x

    def seq_span(self, s: int) -> Tuple[int, int]:
        """This rank's rows ``[a, b)`` of a sequence of ``s`` under ``seq``."""
        n = s // self.mesh.size("model")
        a = self.mesh.index("model") * n
        return a, a + n

    def seq_part(self, x, dim: int = 1):
        """This rank's rows of ``x``'s whole sequence (dim ``dim``)."""
        a, b = self.seq_span(x.shape[dim])
        return x.narrow(dim, a, b - a)

    def gather_seq(self, x, dim: int = 1):
        """Every ``model`` rank's rows of ``x`` (dim ``dim``), in order; the
        gradient summed over ``model`` and cut to the rank's rows."""
        return C.gather(x.contiguous(), dim, self.mesh, "model")

    def seq_last(self, x):
        """``x [b, S/m, ...]`` (the rank's rows) → ``[b, 1, ...]``, the
        sequence's last row, which the last ``model`` rank holds, on every
        rank."""
        return self.gather_seq(x[:, -1:])[:, -1:]

    def log_rows(self, what: str, rows: int) -> None:
        """Append ``(what, rows)`` to :attr:`rows_log` if it is a list."""
        if self.rows_log is not None:
            self.rows_log.append((what, int(rows)))

    def scatter(self, x):
        """Partial sums over ``model`` of a tensor whose last dim is split
        work's (the RG-LRU's gates from its rows of ``w_inp``/``w_rec``):
        summed, and this rank's part of the last dim kept."""
        return C.reduce_scatter(x, x.dim() - 1, self.mesh, "model")

    def reenter(self, x):
        """Partial sums over ``model`` that split work reads whole (Mamba's
        B, C and dt rank from its rows of ``w_bc``/``w_dt1``): summed, and
        their gradient summed too."""
        return C.copy_to(C.reduce_from(x, self.mesh, "model"), self.mesh, "model")

    def batch_offset(self, rows: int) -> int:
        """The global row (within the microbatch) of this rank's first."""
        return self.mesh.index(self.batch) * rows

    # -- the MoE -----------------------------------------------------------
    @property
    def batch_ranks(self) -> int:
        """The ranks along the batch axes (a microbatch's rows split over
        them)."""
        return self.mesh.size(self.batch)

    def gather_batch(self, x):
        """Every batch rank's rows of ``x`` (dim 0) in their global order;
        the gradient summed back to this rank's."""
        return C.gather(x, 0, self.mesh, self.batch)

    def own_rows(self, x, rows: int):
        """This rank's ``rows`` of a tensor gathered by :meth:`gather_batch`."""
        i = self.mesh.index(self.batch)
        return x[i * rows:(i + 1) * rows]

    def expert_logits(self, logits):
        """The router's logits of this rank's experts → of every expert
        (gathered over ``model``): every model rank routes alike."""
        return C.gather(logits, logits.dim() - 1, self.mesh, "model")

    def moe_share(self, spans: bool, seq: bool = False) -> int:
        """The ranks that compute each group's routing: the model ranks of
        expert parallelism or of ``seq`` (whose leaves' gradients are
        summed over ``model``), and the batch ranks when a group spans
        them."""
        return ((self.mesh.size("model") if self.experts or seq else 1)
                * (self.batch_ranks if spans else 1))

    def moe_sum(self, x, seq: bool = False):
        """A rank's share of an MoE term summed over the ranks that share
        its groups (the batch axes, and ``model`` under expert parallelism
        or ``seq``): the global value, its gradient the share's."""
        model = {"model"} if self.experts or seq else set()
        axes = set(self.mesh.axes(self.batch)) | model
        return C.reduce_from(x, self.mesh, tuple(a for a in self.mesh.shape
                                                 if a in axes))

    def batch_sum_(self, x):
        """``x`` summed over the batch axes, in place (no gradient)."""
        return C.all_reduce_(x, self.mesh, self.batch)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor,
              seq: bool = False) -> torch.Tensor:
        """The embedding lookup, vocab-parallel where the vocab is sharded:
        its partial sums summed over ``model``, or under ``seq``
        reduce-scattered to this rank's rows."""
        w = self.weight(table, "embed")
        if not self.vocab:
            return w[tokens]
        rows = w.shape[0]
        local = tokens.long() - self.mesh.index("model") * rows
        own = (local >= 0) & (local < rows)
        x = w[local.clamp(0, rows - 1)] * own[..., None].to(w.dtype)
        return self.leave(x, True, seq)

    def logits(self, xn: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
        """``xn @ lm_head``: this rank's vocab columns where sharded."""
        return self.enter(xn, self.vocab) @ self.weight(head, "lm_head")

    def cross_entropy(self, logits, labels, vocab_size: int, weights=None):
        """``layers.softmax_cross_entropy`` over the mesh. Returns (this
        rank's term of the loss: its weighted CE sum over the global weight
        sum, differentiable; the global loss, detached, equal on every
        rank)."""
        logits = logits.float()
        cols = logits.shape[-1]
        v0 = self.mesh.index("model") * cols if self.vocab else 0
        col = torch.arange(v0, v0 + cols, device=logits.device)
        if v0 + cols > vocab_size:
            logits = logits.masked_fill(col >= vocab_size, NEG_INF)
        if self.vocab:
            m = C.all_reduce_(logits.detach().amax(dim=-1), self.mesh, "model",
                              "max")
            se = C.reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1),
                               self.mesh, "model")
            lse = m + torch.log(se)
            local = labels.long() - v0
            own = (local >= 0) & (local < cols)
            g = torch.gather(logits, -1, local.clamp(0, cols - 1)[..., None])[..., 0]
            gold = C.reduce_from(torch.where(own, g, 0.0), self.mesh, "model")
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        ce = lse - gold
        if weights is None:
            num = ce.sum()
            den = torch.tensor(float(ce.numel()), device=ce.device)
        else:
            w = weights.float()
            num = (ce * w).sum()
            den = w.sum()
        den = C.all_reduce_(den.detach().clone(), self.mesh, self.batch)
        if weights is not None:
            den = torch.clamp(den, min=1.0)
        term = num / den
        return term, C.all_reduce_(term.detach().clone(), self.mesh, self.batch)

    # -- gradients ---------------------------------------------------------
    def _axes(self, name: str) -> Tuple[str, ...]:
        got = set()
        for entry in self.specs[name]:
            got.update(self.mesh.axes(entry))
        return tuple(a for a in self.mesh.shape if a in got)

    def reduce_entry(self, name: str, seq: bool = False) -> Tuple[str, ...]:
        """The axes a leaf's gradient is summed over: the batch axes it is
        replicated over and, after a forward under ``seq``, ``model`` where
        it is replicated over ``model`` and not entered by ``copy_to``
        (its gradient is then partial: its work saw this rank's rows)."""
        own = set(self._axes(name))
        axes = set(self.mesh.axes(self.batch)) - own
        if seq and "model" not in own and \
                _layer_key(name, self.kinds) not in self.partial:
            axes.add("model")
        return tuple(a for a in self.mesh.shape if a in axes)

    def norm_entry(self, name: str) -> Tuple[str, ...]:
        """The axes a leaf is sharded over (its sum of squares is summed
        over them; a replicated leaf counts once)."""
        return self._axes(name)

    @torch.no_grad()
    def reduce_grads(self, grads: Dict[str, torch.Tensor],
                     seq: bool = False) -> None:
        """Sum every gradient over the axes of :meth:`reduce_entry` (``seq``:
        the forward ran under it, :meth:`seq_rows`), in place, in buckets of
        up to :data:`BUCKET` elements."""
        by_entry: Dict[tuple, list] = {}
        for n in grads:
            entry = self.reduce_entry(n, seq)
            if self.mesh.size(entry) > 1:
                by_entry.setdefault(entry, []).append(n)
        for entry, names in by_entry.items():
            start = 0
            while start < len(names):
                chunk, size = [], 0
                while start < len(names) and (not chunk or size + grads[
                        names[start]].numel() <= BUCKET):
                    chunk.append(names[start])
                    size += grads[names[start]].numel()
                    start += 1
                flat = torch.cat([grads[n].reshape(-1).float() for n in chunk])
                C.all_reduce_(flat, self.mesh, entry)
                for n, part in zip(chunk, flat.split(
                        [grads[n].numel() for n in chunk])):
                    grads[n] = part.view(grads[n].shape).to(grads[n].dtype)


def layout_line(cfg, shape: Dict[str, int], s: int, *,
                serve: bool = False) -> str:
    """How a mesh of ``shape`` (axis → size) lays out a forward of ``s``
    positions of ``cfg`` under ``default_rules`` (the prefill rules with
    ``serve``), for a launcher's mesh line: ``seq over model 4; attention's
    query rows over model 4``, or why the sequence stays replicated."""
    import types
    rules = default_rules(types.SimpleNamespace(shape=dict(shape)), cfg,
                          serve=serve).rules
    m = shape.get("model", 1)
    if rules.get("seq") != "model" or m == 1:
        return "the sequence replicated (no seq over model)"
    if s % m:
        return f"the sequence replicated ({s} rows do not split over model {m})"
    line = f"seq over model {m}"
    if rules.get("seq_full") == "model" and cfg.num_heads:
        line += f"; attention's query rows over model {m}"
    return line


def shard_batch(batch: Dict[str, Any], shardings: Dict[str, NamedSharding],
                device=None) -> Dict[str, torch.Tensor]:
    """This rank's rows of a batch (host arrays or tensors) as tensors on
    ``device`` (default: where they are): only those rows are copied."""
    out = {}
    for k, v in batch.items():
        part = shardings[k].shard(v) if k in shardings else v
        t = torch.as_tensor(part) if not isinstance(part, torch.Tensor) else part
        out[k] = t.contiguous() if device is None else t.to(device).contiguous()
    return out


def batch_shardings(mesh, rules, microbatch: Optional[int] = None
                    ) -> Dict[str, NamedSharding]:
    """The batch's shardings (``tokens``, ``labels``, ``embeds``,
    ``segment_ids``, ``positions``): rows over the rules' batch axes, in
    blocks of ``microbatch`` rows where given (a rank holds its slice of
    every microbatch)."""
    rows = rules.spec_for(("batch",))[0]
    block = (microbatch,) if microbatch else ()
    sh = NamedSharding(mesh, (rows, None), block)
    return {"tokens": sh, "labels": sh, "segment_ids": sh, "positions": sh,
            "embeds": NamedSharding(mesh, (rows, None, None), block)}
