"""A llama-class decoder served by the port's `DecodeScheduler`: w4
weights, an int8 KV cache, bucketed admissions, captured decode windows.
Requests come from the traffic's generator (`loads.start`) through
`DecodeScheduler.submit(on_token=...)`.  After the window the runner holds
its records for the metric readers: `sent` (every request, each token's
arrival), `delta` (the scheduler's spans and counters over the part of the
window before any trace), `t_open`, `t_mid`, `t_close`, `window_s`."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import inputs, loads
from ..reference.decoder import Decoder


def _sleep_until(t: float) -> None:
    while True:
        d = t - time.perf_counter()
        if d <= 0:
            return
        time.sleep(min(d, 0.5))


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.config, ctx.traffic
        self.sched = None
        self.sent = []

    # ------------------------------------------------------------ set-up
    def setup(self):
        from anakin_tpu_torch.models.transformer import TransformerConfig
        from anakin_tpu_torch.runtime.decode_scheduler import DecodeScheduler

        c, ctx = self.cfg, self.ctx
        E = c["hidden_size"]
        if c["intermediate_size"] % E or c.get("w4_group", 128) != 128:
            raise ValueError("the scheduler takes mlp_mult * hidden and w4 "
                             "groups of 128")
        tc = TransformerConfig(
            vocab=c["vocab_size"], embed=E, heads=c["num_attention_heads"],
            kv_heads=c["num_key_value_heads"], layers=c["num_hidden_layers"],
            mlp_mult=c["intermediate_size"] // E,
            max_seq=c["max_position_embeddings"], norm="rms", mlp="swiglu")
        t0 = time.perf_counter()
        params = inputs.decoder_weights_numpy(c, ctx.seed, ctx.device)
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        self.sched = DecodeScheduler(
            tc, batch=c["slots"], params=params, precision=c["precision"],
            kv_cache_dtype=c["kv_cache_dtype"], kv_scale=c["kv_scale"],
            weight_only=c["weight_only"], prefill_mode=c["prefill_mode"],
            fuse_window=c["fuse_window"], cache_view=c["cache_view"],
            device=ctx.device)
        t2 = time.perf_counter()
        # every bucket and cache view the traffic reaches, one request at a
        # time (a request admitted beside another shares its view)
        rng = inputs.seed_rng(ctx.seed, 5)
        for P, n in self.traffic["warmup"]:
            prompt = rng.integers(0, c["vocab_size"], int(P)).astype(np.int32)
            self.sched.submit(prompt, int(n)).result(timeout=900)
        t3 = time.perf_counter()
        self.pool = loads.plan_requests(self.traffic, ctx.seed,
                                        c["vocab_size"])
        print(f"setup: weights made and copied to the host {t1 - t0:.1f} s, "
              f"scheduler built {t2 - t1:.1f} s, warm-up requests "
              f"{t3 - t2:.1f} s", file=sys.stderr, flush=True)

    def _counters(self):
        s = self.sched
        ps = getattr(s, "phase_seconds", {})
        return {"window_s": ps.get("window"), "prefill_s": ps.get("prefill"),
                "windows": getattr(s, "fused_windows_run", None)}

    # ------------------------------------------------------------ window
    def window(self):
        ctx, tr, sched = self.ctx, self.traffic, self.sched

        def submit(prompt, max_new, on_token):
            return sched.submit(prompt, max_new, on_token=on_token)

        c0 = self._counters()
        t_open = time.perf_counter()
        t_stop = t_open + ctx.seconds
        gen = loads.start(tr, submit, self.pool, t_open, t_stop)
        if ctx.launches is not None:
            # the clean part, which the span metrics read, then the trace,
            # begun early enough (the profiler takes a second or more to
            # start) that a second try fits in the window if the first
            # comes back empty
            ts = float(tr["trace_seconds"])
            _sleep_until(t_stop - 2 * (ts + 3.0))
            self.t_mid, c1 = time.perf_counter(), self._counters()
            for _ in range(2):
                with ctx.traced() as t:
                    time.sleep(ts)
                if not t.empty:
                    break
        _sleep_until(t_stop)
        self.t_close = time.perf_counter()
        if ctx.launches is None:
            self.t_mid, c1 = self.t_close, self._counters()
        self.t_open, self.window_s = t_open, self.t_close - t_open
        self.delta = {k: (None if c0[k] is None or c1[k] is None
                          else c1[k] - c0[k]) for k in c0}
        gen.settle(time.perf_counter() + 120.0)
        self.sent, self.owes_all = list(gen.sent), gen.owes_all
        if gen.lateness:
            late = np.array(gen.lateness) * 1e3
            print(f"{len(late)} requests sent; generator late by ms p50 "
                  f"{np.percentile(late, 50):.3f} p99 "
                  f"{np.percentile(late, 99):.3f} max {late.max():.3f}",
                  file=sys.stderr, flush=True)
        for r in self.sent:
            f = r.future
            if f.cancelled() or not f.done():
                continue
            if f.exception() is not None:
                r.error = f.exception()
            else:
                r.tokens = np.asarray(f.result())[len(r.prompt):]
                if list(r.tokens) != r.streamed:  # streamed is served
                    r.error = RuntimeError("streamed tokens differ from the "
                                           "result")

    def _in_window(self, t: float) -> bool:
        return self.t_open <= t <= self.t_close

    def end_to_end(self):
        """Every end-to-end metric the records give; the harness reports
        the cell's own."""
        n = sum(sum(1 for t in r.times if self._in_window(t))
                for r in self.sent)
        out = {"out_tok_per_s": n / self.window_s}
        ttft = [1e3 * (r.times[0] - r.due) for r in self.sent if r.times]
        tpot = [1e3 * (r.times[-1] - r.times[0]) / (len(r.times) - 1)
                for r in self.sent if r.tokens is not None and len(r.times) > 1]
        if ttft:
            out["ttft_ms_p90"] = float(np.percentile(ttft, 90))
        if tpot:
            out["tpot_ms_p90"] = float(np.percentile(tpot, 90))
        return out

    def counts(self):
        """(attempted, failed): a request fails when it errs, or, where the
        generator owes every request an answer, when none came."""
        failed = sum(r.error is not None
                     or (self.owes_all and r.tokens is None)
                     for r in self.sent)
        return len(self.sent), failed

    def release(self):
        if self.sched is not None:
            self.sched.close()
            self.sched = None

    @property
    def trace(self):
        return self.ctx.trace_data

    # ------------------------------------------------------------- check
    def sample(self):
        """The requests compared, as (request, served tokens compared): the
        longest one finished in the window, whole; every request sent when
        the window opened (in a closed loop one a slot, admitted together);
        then others in an order drawn from the seed, until
        `check_requests`.  Each but the longest is compared over its first
        `check_prefix` served tokens.  Where none finished, the tokens
        streamed so far of those in flight at the close (as `on_token`
        gave them)."""
        tr = self.traffic
        done = [r for r in self.sent if r.tokens is not None and len(r.tokens)
                and (self.owes_all or r.times[-1] <= self.t_close)]
        if not done:
            done = [r for r in self.sent if len(r.streamed) >= 2]
            for r in done:
                r.tokens = np.asarray(r.streamed, np.int32)
        if not done:
            return []
        longest = max(done, key=lambda r: (len(r.tokens), -r.idx))
        rest = [r for r in done if r is not longest]
        order = inputs.seed_rng(self.ctx.seed, 6).permutation(len(rest))
        rest = ([r for r in rest if r.at_open]
                + [rest[j] for j in order if not rest[j].at_open])
        prefix = int(tr["check_prefix"])
        picked = rest[:max(0, int(tr["check_requests"]) - 1)]
        return [(longest, len(longest.tokens))] + [
            (r, min(prefix, len(r.tokens))) for r in picked]

    def gaps(self, requests, ref: Decoder, pick: Decoder = None):
        """How far below the reference's best each served token's reference
        logit lies, over `requests` ((request, tokens compared) pairs):
        (the widest gap, the mean gap); with `pick`, of the token that
        `pick` puts first at each position."""
        worst, total, n = 0.0, 0.0, 0
        dev = self.ctx.device
        for r, k in requests:
            P, served = len(r.prompt), r.tokens[:k]
            toks = torch.as_tensor(np.concatenate([r.prompt, served[:-1]]),
                                   device=dev)
            want = ref.logits(toks, P)
            if pick is None:
                chosen = torch.as_tensor(served.astype(np.int64), device=dev)
            else:
                chosen = pick.logits(toks, P).argmax(dim=1)
            gap = want.max(dim=1).values - want.gather(1, chosen[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
            total += float(gap.sum())
            n += gap.numel()
        return worst, total / max(n, 1)

    def check(self, control: bool = False):
        """The widest and the mean gap of a served token's reference logit
        below the reference's best over the sampled requests.  With `control`, the
        reading of the lower-precision control (the reference with float8
        activations) in the program's place: at each position the token it
        puts first."""
        reqs = self.sample()
        if not reqs:
            return {}
        w = inputs.decoder_weights(self.cfg, self.ctx.seed, self.ctx.device)
        ref = Decoder(self.cfg, w)
        widest, mean = self.gaps(reqs, ref, Decoder(self.cfg, w, act_bits=8)
                                 if control else None)
        print(f"checked {len(reqs)} requests, {sum(k for _, k in reqs)} "
              f"served tokens ({sum(r.at_open for r, _ in reqs)} sent at "
              f"the open)"
              + (" (control)" if control else ""),
              file=sys.stderr, flush=True)
        return {"served_logit_gap": widest, "served_logit_gap_mean": mean}
