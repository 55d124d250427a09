"""The serving driver: the port's ``serving.ServingEngine`` over the page
pool, driven as ``run()`` drives it (one ``_iteration`` after another, the
engine having no public single-iteration call), by a closed loop of
clients.

Each client sends its next request as soon as its last one has emitted
its last token; the stream of requests is the mix's, from the seed. Set-up
loads the weights, builds the engine and runs the loop until
``warmup_requests`` have completed: every shape the traffic uses (packed
prefill rows, the decode step) has then run. The window opens on the
running loop and closes at the first iteration that ends ``--seconds``
later; after it no request is sent, and the loop serves until every
request sent in the window has completed. Time to first token runs from
a request's sending to the moment its first token's logits reach the
host, whatever route gave them (a packed row of whole prompts, a chunk,
the suffix after a cached prefix). The mix's ``pages`` are the page pool's
``PagedCacheConfig``; its ``engine`` object is passed whole to
``ServingEngine`` as keywords. A traced run profiles ``trace_seconds``
from the middle of the window on (the window closes no earlier than the
profile).

Correctness: the requests sent in the window and completed (a sample,
drawn from the seed, with the longest of them, until ``check_tokens``
served tokens where the mix sets that; every one where it is null); the
plain reference runs each prompt with its served tokens once. Two numbers are compared: ``token_gap``, the widest gap by which a
served token's reference logit lies below the reference's best at its
position, and ``logit_gap``, the largest difference between the logits the
engine produced at the served positions and the reference's, over
``probes`` vocabulary ids drawn from the seed (the engine's logits are
kept at those ids as they reach the host).
"""

from __future__ import annotations

import gc
import math
from types import SimpleNamespace

import numpy as np

from bench import flops, readers, trace, traffic, weights


def _engine_class():
    from repro_torch.serving import ServingEngine

    class BenchEngine(ServingEngine):
        """The engine with host spans around its device steps
        (``prefill_step``: a packed row of whole prompts or of prompt spans;
        ``decode_step``: a decode or verify step), each from the step call
        to its logits on the host, and ``iteration`` around each iteration.
        Whatever route a token takes (packed prefill, a chunk or the suffix
        after a cached prefix, decode, verify), it is recorded as its
        logits reach the host: a request's first-token time, and the
        engine's logits at the probe ids for each served token."""

        def __init__(self, rec, probe_ids, *args, **kw):
            super().__init__(*args, **kw)
            self.rec, self.probe_ids = rec, probe_ids
            self.first_token = {}       # rid → time its first token was on the host
            self.probes = {}            # rid → {output index: the engine's
                                        #        logits at the probe ids}
            self.prefills = []          # (time, spans (start, end) of a row,
                                        #  its step's seconds)
            self.decode_rows = []       # (time, kv_len of each decoding row,
                                        #  tokens emitted)
            self.emitted = []           # (time, tokens a request gained in a step)
            self._open = None
            self.prefill_fn = self._timed(self.prefill_fn, "prefill_step")
            self.chunk_prefill_fn = self._timed(self.chunk_prefill_fn, "prefill_step")
            self.decode_fn = self._timed(self.decode_fn, "decode_step")
            if self.verify_fn is not None:
                self.verify_fn = self._timed(self.verify_fn, "decode_step")

        def _timed(self, fn, name):
            def call(*args):
                rf = None
                if self.rec.tracing:
                    from torch.profiler import record_function
                    rf = record_function(trace.SPAN_PREFIX + name)
                    rf.__enter__()
                self._open = (name, self.rec.clock(), rf)
                return fn(*args)
            return call

        def _host(self, logits):
            out = ServingEngine._host(logits)
            self._last = out
            if self._open is not None:
                name, t0, rf = self._open
                self._open = None
                if rf is not None:
                    rf.__exit__(None, None, None)
                self.rec.spans.append((name, t0, self.rec.clock(), {}))
            return out

        def _iteration(self):
            with self.rec.span("iteration"):
                super()._iteration()

        def _took(self, seq, before: int, rows) -> None:
            """Record the tokens ``seq`` gained in the step just run (its
            output past ``before``), the k-th from logits row ``rows[k]``."""
            out = seq.all_generated
            if len(out) == before:
                return
            rid, now = seq.request.rid, self.rec.clock()
            self.first_token.setdefault(rid, now)
            self.emitted.append((now, len(out) - before))
            got = self.probes.setdefault(rid, {})
            for k in range(before, len(out)):
                got[k] = rows[k - before][self.probe_ids]

        def _row_done(self, spans) -> None:
            _, t0, t1, _ = self.rec.spans[-1]          # this row's prefill_step
            self.prefills.append((self.rec.clock(), spans, t1 - t0))

        def _prefill(self, seqs):
            for row in self._pack_rows(seqs):
                lens = [s.request.prompt_len for s in row]
                self.rec.context["pairs"] = sum(flops.causal_pairs(n) for n in lens)
                before = [len(s.all_generated) for s in row]
                super()._prefill(row)
                self._row_done([(0, n) for n in lens])
                for li, s in enumerate(row):
                    self._took(s, before[li], self._last[li][None])

        def _prefill_chunks(self, spans):
            # rows as the engine packs them (first fit, in order), one call
            # each, so that each host call's logits rows are this row's spans
            rows, used = [[]], 0
            for sp in spans:
                n = sp[2] - sp[1]
                if used + n > self.prefill_len:
                    rows.append([])
                    used = 0
                rows[-1].append(sp)
                used += n
            for row in rows:
                # each span's tokens read K/V positions [0, end) of its prompt
                self.rec.context["decode_kv"] = sum(b for _, _, b in row)
                before = [len(s.all_generated) for s, _, _ in row]
                super()._prefill_chunks(row)
                self._row_done([(a, b) for _, a, b in row])
                for li, (s, _, _) in enumerate(row):
                    self._took(s, before[li], self._last[li][None])

        def _decoding(self):
            kvl = self.scheduler.tables.kv_len.copy()
            rows = []
            for slot, seq in self.scheduler.active.items():
                if seq.prefilling:
                    kvl[slot] = 0
                else:
                    rows.append((slot, seq, len(seq.all_generated), int(kvl[slot])))
            self.rec.context["decode_kv"] = int((kvl + 1).sum())
            return rows

        def _decode(self):
            rows = self._decoding()
            emitted = super()._decode()
            self.decode_rows.append((self.rec.clock(), [kv for *_, kv in rows], emitted))
            for slot, seq, before, _ in rows:
                self._took(seq, before, self._last[slot][None])
            return emitted

        def _decode_spec(self):
            rows = self._decoding()
            emitted = super()._decode_spec()
            self.decode_rows.append((self.rec.clock(), [kv for *_, kv in rows], emitted))
            for slot, seq, before, _ in rows:
                self._took(seq, before, self._last[slot])
            return emitted

    return BenchEngine


class ClosedLoop:
    """Clients that each send their next request when the last completes.
    While ``warming``, requests come from the warm-up stream, whose sizes
    are the same for every seed (so set-up does the same work); then from
    the seed's stream."""

    def __init__(self, engine, mix, conf, seed, rec):
        self.engine, self.mix, self.conf, self.seed, self.rec = engine, mix, conf, seed, rec
        self.next_index = {True: 0, False: 0}
        self.sent = {}          # rid → (time sent, in the window's stream, prompt)
        self.done = set()       # rids whose last token has been emitted
        self.sending = True
        self.warming = True

    def send(self):
        k = self.next_index[self.warming]
        tokens, out_len = traffic.serve_request(self.mix, self.conf, self.seed, k,
                                                warmup=self.warming)
        rid = self.engine.submit(tokens, out_len)
        self.sent[rid] = (self.rec.clock(), not self.warming, tokens)
        self.next_index[self.warming] = k + 1

    def start(self):
        for _ in range(self.mix["clients"]):
            self.send()

    def step(self):
        eng = self.engine
        eng._iteration()
        eng._iter += 1
        now = self.rec.clock()
        finished = [s.request.rid for s in eng.scheduler.active.values() if s.done]
        finished += [rid for rid in eng.results if rid not in self.done]
        for rid in finished:
            if rid in self.done:
                continue
            self.done.add(rid)
            if self.sending:
                self.send()
        return now

    def in_flight(self, rids):
        """Those of ``rids`` the engine has no outcome for yet (a finished
        request gets its outcome when the next iteration evicts it)."""
        return [r for r in rids if r not in self.engine.results]


def run(ctx):
    import torch
    from repro_torch.models import lm
    from repro_torch.serving import Outcome, PagedCacheConfig

    cfg, conf, mix, rec, dev = ctx.cfg, ctx.config, ctx.mix, ctx.rec, ctx.device
    ref = ctx.reference
    leaves = ref.leaves(conf)
    pcfg = PagedCacheConfig(**mix["pages"])
    params = lm.LM(cfg, cfg.vocab_size, device=dev)
    with torch.no_grad():
        weights.load(lambda n, t: params.get_parameter(n).copy_(t), leaves,
                     ctx.seed, dev)
    params.requires_grad_(False)
    probe_ids = np.random.RandomState(int(ctx.seed) % (2 ** 31 - 1)).choice(
        conf["vocab_size"], mix["probes"], replace=False)
    engine = _engine_class()(rec, probe_ids, cfg, pcfg, params, impl="kernel",
                             device=dev, **mix["engine"])
    loop = ClosedLoop(engine, mix, conf, ctx.seed, rec)
    loop.start()
    while len(loop.done) < mix["warmup_requests"]:
        loop.step()
    loop.warming = False
    if dev != "cpu":
        torch.cuda.synchronize()
        peak_setup = torch.cuda.max_memory_allocated()
    setup_s = rec.clock() - ctx.t_start

    # -- the window --------------------------------------------------------
    prof = ctx.profile
    t0 = rec.clock()
    pool0 = len(engine.pool_samples)
    t1 = None
    while t1 is None:
        if prof is not None and not prof.ran and rec.clock() - t0 >= ctx.seconds / 2:
            prof.start()
        now = loop.step()
        if prof is not None and prof.active and now - prof.t0 >= mix["trace_seconds"]:
            prof.stop()
        if now - t0 >= ctx.seconds and (prof is None or not prof.active):
            t1 = now
    loop.sending = False
    pool_fill = engine.pool_samples[pool0:len(engine.pool_samples)]
    window_rids = [r for r, (ts, in_window, _) in loop.sent.items()
                   if in_window and ts < t1]
    drain_until = rec.clock() + mix["drain_s"]
    while loop.in_flight(window_rids) and rec.clock() < drain_until:
        loop.step()
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    if dev != "cpu":
        peak = max(peak, peak_setup)

    # what the window did, from the host spans and the engine's records
    rows = [r for r in engine.prefills if t0 <= r[0] <= t1]
    decodes = [d for d in engine.decode_rows if t0 <= d[0] <= t1]
    tokens = sum(n for t, n in engine.emitted if t0 <= t <= t1)
    ttft = [engine.first_token.get(r, math.inf) - loop.sent[r][0] for r in window_rids]
    results = {r: engine.results.get(r) for r in window_rids}
    completed = [r for r, res in results.items()
                 if res is not None and res.outcome is Outcome.COMPLETED]
    served = {r: (loop.sent[r][2], list(results[r].tokens), engine.probes.get(r, {}))
              for r in completed}
    beyond = sum(x > readers.nearest_rank(ttft, 0.9) for x in ttft) if ttft else 0
    ctx.log(f"set-up {setup_s:.1f} s; window {t1 - t0:.2f} s; drain "
            f"{rec.clock() - t1:.1f} s; {len(rows)} prefill rows, {len(decodes)} "
            f"decode steps in the window; {len(ttft)} first tokens, {beyond} beyond "
            f"their p90; pool {100 * np.mean(pool_fill or [0]):.1f} % used on average, "
            f"{100 * max(pool_fill or [0]):.1f} % at most; "
            f"{engine.scheduler.preemptions} preemptions")
    del engine, loop, params
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()

    # -- the reference over a sample of the served requests -----------------
    t_ref = rec.clock()
    sample = _sample(served, ctx.seed, mix["check_tokens"])
    token_gap = logit_gap = 0.0
    probes = torch.as_tensor(probe_ids, device=dev)
    with ref.full_f32():
        p = weights.own(leaves, ctx.seed, dev)
        for rid in sample:
            prompt, out, rows_got = served[rid]
            if sorted(rows_got) != list(range(len(out))):
                ctx.log(f"request {rid}: {len(out)} served tokens, the engine's "
                        f"logits recorded for {len(rows_got)}")
                logit_gap = math.inf
                continue
            got = np.stack([rows_got[k] for k in range(len(out))])
            seq = np.concatenate([prompt, np.asarray(out[:-1], np.int32)])
            logits = ref.logits_rows(p, conf, torch.as_tensor(seq, device=dev),
                                     list(range(len(prompt) - 1, len(seq))))
            best = logits.max(dim=-1).values
            chosen = logits.gather(1, torch.as_tensor(out, device=dev)[:, None].long())[:, 0]
            token_gap = max(token_gap, (best - chosen).max().item())
            logit_gap = max(logit_gap, (torch.as_tensor(got, device=dev)
                                        - logits[:, probes]).abs().max().item())
    del p
    n_served = sum(len(served[r][1]) for r in sample)
    ctx.log(f"{len(window_rids)} requests sent in the window, {len(completed)} "
            f"completed; checked {len(sample)} of them ({n_served} served tokens) "
            f"in {rec.clock() - t_ref:.1f} s")
    run_record = SimpleNamespace(
        kind="serve", cell=ctx.cell, config=conf, mix=mix, rec=rec,
        setup_s=setup_s, window_s=t1 - t0, t0=t0, t1=t1, tokens=tokens,
        ttft_s=ttft, rows=rows, decodes=decodes, pool_fill=pool_fill,
        profiled=None if prof is None else prof.interval,
        profile=None if prof is None else prof.reduce(ctx.log), dtype=conf["dtype"])
    return SimpleNamespace(run=run_record,
                           numbers={"token_gap": token_gap, "logit_gap": logit_gap},
                           attempted=len(window_rids),
                           failed=len(window_rids) - len(completed),
                           peak_bytes=peak)



def _sample(served, seed: int, want):
    """The longest served request, then others in an order drawn from the
    seed, until ``want`` served tokens (None: all of them)."""
    if not served:
        return []
    want = math.inf if want is None else want
    rids = sorted(served)
    longest = max(rids, key=lambda r: (len(served[r][0]) + len(served[r][1]), r))
    rest = [r for r in np.random.RandomState(int(seed) % (2 ** 31 - 1)).permutation(rids)
            if r != longest]
    out, n = [longest], len(served[longest][1])
    for r in rest:
        if n >= want:
            break
        out.append(int(r))
        n += len(served[r][1])
    return out
