"""The int8 CNN on the port's `Net`: `models.build_resnet` ->
`optimize()` -> `quant.quantize_graph` with the configuration's scale
table -> `Net(precision=...)`, eager, stepped back to back on a ring of
device-resident batches (the traffic's "offline" generator).  After the
window the runner holds its records for the metric readers: `steps`,
`window_s`, `clean` (steps and seconds of the untraced part, closed by a
sync), `enqueue_s` (a traced run's timed calls), `batch`, `size`."""

from __future__ import annotations

import os
import sys
import time

import torch

from .. import inputs, spec
from ..reference.resnet_int8 import ResNetInt8, read_scales


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.config, ctx.traffic
        self.batch = int(self.traffic["batch"])
        self.size = int(self.cfg["image_size"])
        self.kept = {}
        self.net = None
        self.clean = None    # (steps, seconds) before the trace

    # ------------------------------------------------------------ set-up
    def setup(self):
        from anakin_tpu_torch import Net, optimize
        from anakin_tpu_torch.models.resnet import build_resnet
        from anakin_tpu_torch.quant import quantize_graph

        cfg = self.cfg
        t0 = time.perf_counter()
        g = build_resnet(tuple(cfg["layers"]), self.batch, self.size,
                         num_classes=cfg["num_classes"],
                         seed=cfg["weight_seed"], name="resnet50")
        self.weights = inputs.resnet_weights(cfg)
        names = list(g.params)
        if len(names) != len(self.weights):
            raise RuntimeError(f"the builder holds {len(names)} params, the "
                               f"benchmark made {len(self.weights)}")
        for n, w in zip(names, self.weights):  # both in the order drawn
            if g.params[n].shape != w.shape:
                raise RuntimeError(f"param {n}: {g.params[n].shape} != "
                                   f"{w.shape}")
            g.params[n] = w
        self.table = read_scales(os.path.join(spec.ROOT, cfg["scale_table"]))
        gq = quantize_graph(optimize(g), self.table)
        (soft,) = [n for n in gq.nodes.values() if n.op == "softmax"]
        self.logits_edge = soft.inputs[0]
        self.net = Net(gq, precision=cfg["precision"], device=self.ctx.device,
                       tap_edges=[self.logits_edge])
        t1 = time.perf_counter()
        self.ring = inputs.image_batches(self.ctx.seed, int(self.traffic["ring"]),
                                         self.batch, self.size, self.ctx.device)
        for x in self.ring:          # every shape the window runs
            self.net({"input": x})
        self._sync()
        t = time.perf_counter()
        for x in self.ring:
            self.net({"input": x})
        self._sync()
        self.step_estimate = (time.perf_counter() - t) / len(self.ring)
        print(f"setup: graph, weights, quantization and Net {t1 - t0:.1f} s, "
              f"inputs and warm-up {time.perf_counter() - t1:.1f} s",
              file=sys.stderr, flush=True)

    def _sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    # ------------------------------------------------------------ window
    def window(self):
        """Steps back to back for the window; the checked steps' outputs
        kept.  A traced run first times the enqueue of isolated steps, then
        steps untraced (the clean part, closed by a sync, which
        `mfu_pct.offline` reads), then traces `trace_seconds` of steps near the
        window's end (a second time if the first trace came back empty)."""
        ctx, tr, net, ring = self.ctx, self.traffic, self.net, self.ring
        traced = ctx.launches is not None
        if traced:
            self.enqueue_s = self._enqueue_s()
        # the steps whose outputs are checked: a sample drawn from the seed
        # over the steps the window is expected to run, and the last one
        n_est = max(1, int(ctx.seconds / self.step_estimate))
        rng = inputs.seed_rng(ctx.seed, 4)
        keep = set(rng.choice(n_est, min(n_est, int(tr["check_steps"])),
                              replace=False).tolist())
        t_open = time.perf_counter()
        t_end = t_open + ctx.seconds
        ts = float(tr["trace_seconds"])
        t_trace = t_end - 2 * (ts + 2.0)  # room for a second try
        state, tries, span, trace_until = "clean", 0, None, None
        i, out = 0, None
        while True:
            now = time.perf_counter()
            if state == "tracing" and now >= trace_until:
                span.__exit__(None, None, None)    # syncs: steps traced whole
                tries += 1
                state = "clean" if span.empty and tries < 2 else "done"
            if now >= t_end and state != "tracing":
                break
            if traced and state == "clean" and now >= t_trace:
                if self.clean is None:
                    self._sync()
                    self.clean = (i, time.perf_counter() - t_open)
                span = ctx.traced()
                span.__enter__()
                trace_until = time.perf_counter() + ts
                state = "tracing"
            out = net({"input": ring[i % len(ring)]})
            if i in keep:
                self.kept[i] = out[self.logits_edge]
            i += 1
        self._sync()
        self.window_s = time.perf_counter() - t_open
        self.kept[i - 1] = out[self.logits_edge]
        self.steps = i
        if not traced:
            self.clean = (self.steps, self.window_s)

    def _enqueue_s(self, n: int = 32):
        """Host seconds for each of `n` calls of `Net.__call__` to return,
        the card idle before each call."""
        out = []
        x = self.ring[0]
        for _ in range(n):
            self._sync()
            t = time.perf_counter()
            self.net({"input": x})
            out.append(time.perf_counter() - t)
        self._sync()
        return out

    def end_to_end(self):
        return {"img_per_s": self.steps * self.batch / self.window_s}

    def counts(self):
        return self.steps * self.batch, 0

    def release(self):
        self.net = None

    @property
    def trace(self):
        return self.ctx.trace_data

    # ------------------------------------------------------------- check
    def check(self, control: bool = False):
        """The widest relative error (L2) of an image's logits over the
        checked steps against the reference on the same batch.  With
        `control`, the reading of the lower-precision control (the
        reference with int4 weights) in the program's place."""
        ref = ResNetInt8(self.cfg, self.weights, self.table, self.ctx.device)
        low = (ResNetInt8(self.cfg, self.weights, self.table, self.ctx.device,
                          weight_bits=4) if control else None)
        worst = 0.0
        block = 32
        for i, got in sorted(self.kept.items()):
            x = self.ring[i % len(self.ring)]
            for a in range(0, self.batch, block):
                want = ref(x[a:a + block])
                g = (low(x[a:a + block]) if control
                     else got[a:a + block].to(torch.float32))
                err = (g - want).norm(dim=1) / want.norm(dim=1)
                worst = max(worst, float(err.max()))
        return {"logit_rel_err": worst}
