"""Continuous-batching decode scheduler (slot-based): the port of
`anakin_tpu/runtime/decode_scheduler.py`.

A fixed-batch decode `Net` whose B slots each hold an independent sequence
at its own position; requests join a free slot at any step and leave when
they stop, reach their budget or are cancelled.

Prompt admission (`prefill_mode`):

  * "bucket" (default): a newly admitted prompt is scored in one dispatch
    of a bucketed-length prefill graph (`mha_prefill`, the flash kernel on
    CUDA from a 512-token bucket on, where it takes the head dim) that
    returns only each slot's last-real-token logits; the admitted slots'
    cache rows are then copied into the live caches in place.  Slots
    admitted together share one dispatch per bucket (32, 64, then
    multiples of 128).
  * "chunked": while a slot has prompt tokens left, the step runs the
    chunk-verify graph (`mha_verify`), `prefill_chunk` tokens a slot a
    dispatch; decoding slots ride the chunk.

Requests: `stop_tokens` end a request early (at most `MAX_STOP_IDS`; the
stop token is the last one returned), `on_token` streams each token from
the scheduler's thread, `future.cancel()` frees the slot at the next step.

Sampling: greedy (temperature 0, the default) or temperature softmax with
top-k then top-p filters, per request.  The host paths draw from numpy's
`default_rng([seed, request id])`, exactly as the JAX package does.  Fused
windows sample on the device, where the JAX package uses its PRNG: here a
counter-based hash of (seed, request id, token index, vocabulary index)
gives each draw's uniforms, and the Gumbel-max trick picks the token
(`device_sample`), so a request's draws depend on nothing else in the
batch and on no admission timing.  Greedy is bit-exact on every path.

Fused steady state (`fuse_window=K`): while every active slot is past its
prompt, K decode steps run as one unit that carries (token, position,
alive) on the device, with per-slot budgets `rem` and a stop-id table
freezing slots that finish inside it, and returns one packed [K+1, B]
int32 tensor: the K steps' tokens and, in its last row, `k_done`, the
steps in which some slot had work (the JAX `while_loop`'s count).  On
CUDA the window is a captured CUDA graph (`runtime.graphs`), one per
(sampling, cache view), that always runs its K steps: a frozen slot
rewrites its cache row at its frozen position with the same values, so
the tail after every slot froze changes nothing the host reads.  The
per-step decode and the chunk step replay captured graphs on CUDA too; the
bucket prefill runs eagerly (one long dispatch per bucket).  On the CPU
every step runs eagerly, the window K times.

The caches are allocated once and written in place by every path, so the
captured graphs keep their addresses; `_fail_active` (a failed device step
fails the in-flight futures) zeroes them in place.  Every device step is
guarded that way (the JAX package guards the window and the bucket
prefill; a failing per-step decode or chunk step ends its thread).

Cache views (`cache_view="auto"`): a window attends only the first `view`
cache rows, the smallest of 128, 256, ... (doubling) that holds every
active slot's position at the window's end; `"off"` reads every row.

`device=None` means CUDA.

Tracing: the scheduler records its work as spans on the host clock
(`runtime.profiler.SpanRecorder`, `sched.spans`; always on, nothing per
token or per graph node):

  * `window` (attributes view, K, active, k_done), with children
    `window.build` (the capture, at first use only), `window.launch` (the
    feed's copies and the replay call: its children `window.launch.fill`
    and `.replay`, `runtime.graphs`), `window.readback` (until the
    tokens are on the host) and `window.emit` (the host mirrors, the
    tokens handed out, finished requests; `callback_ns`: the time inside
    `on_token` and the futures' callbacks);
  * `admission`, one a bucket dispatch (attributes L, slots, rows_real =
    the prompts' tokens, rows_launched = B x L), with children
    `admission.build`, `admission.enqueue` (the prefill net and the cache
    rows' copies), `admission.readback` and `admission.emit`;
  * `step` and `chunk` (the per-step decode, the chunk step; children
    `.build`, `.fill`, `.replay`), `admit` (slots assigned), `idle`
    (waiting for work, one span however long the wait);
  * `request`, one a request when it ends: from its submission to its end,
    with the times (perf_counter_ns) its admission dispatch started
    (`dispatch`) and its first token came (`first`), its prompt length,
    tokens and finish reason.

`phase_seconds` reads those spans: "window" sums the `window` spans and
"prefill" the `admission` spans, each up to its `.emit` child, and the
`chunk` spans whole; "step" sums the `step` spans.  `builds` counts the
nets and captures made at first use, by kind.

Tensor parallelism (`mesh=`, a `parallel.Mesh`; every rank of it builds the
same scheduler): the nets run as the JAX scheduler builds them under a
mesh, with the Megatron rules of `parallel.shard_graph_params` and the KV
caches head-sharded (each rank holds Hkv/tp heads of every cache, where tp
divides Hkv), every other input whole on every rank.  The mesh's first
rank takes the submissions (`submit` raises on the others) and, before
each step, broadcasts the step's plan to every rank: the requests
admitted, the slots cancelled, and whether to stop; after each step it
broadcasts the tokens it chose, which every rank then stores
(`token_disagreements` counts the steps where a rank's own choice
differed).  So every rank runs the same steps.  Under a mesh the fused
windows, the per-step decode and the chunk step run eagerly: a gloo
mesh's collectives run on the host, which a CUDA graph cannot capture.
Every rank calls `close()`; the first rank's ends the others' loops.

Usage:
    sched = DecodeScheduler(cfg, batch=8, fuse_window=16)   # on CUDA
    fut = sched.submit(prompt_ids, max_new_tokens=32, temperature=0.8,
                       top_k=40, stop_tokens=(eos_id,))
    tokens = fut.result()
    sched.close()
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.transformer import (
    TransformerConfig,
    build_transformer_decode_step,
    build_transformer_prefill,
    build_transformer_verify_step,
    make_transformer_params,
)
from ..quant import weight_only_quantize
from .generate import prefill_attention_impl, prefill_bucket
from .graphs import EagerStep, compile_step
from .net import Net, _check_mesh, _resolve_device
from .profiler import SpanRecorder

__all__ = ["DecodeScheduler", "device_sample", "sample_token"]

_log = logging.getLogger("anakin_tpu_torch")

def sample_token(logits: np.ndarray, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0,
                 rng: Optional[np.random.Generator] = None) -> int:
    """Sample one token id from a [V] logit row.

    temperature == 0 -> argmax (greedy).  top_k > 0 keeps only the k most
    likely tokens; 0 < top_p < 1 keeps the smallest set whose probability
    mass reaches top_p (nucleus).  Filters compose (k first, then p).
    """
    logits = np.asarray(logits, np.float64).reshape(-1)
    if temperature <= 0.0:
        return int(np.argmax(logits))
    z = logits / float(temperature)
    if top_k and top_k < z.size:
        kth = np.partition(z, -top_k)[-top_k]
        z = np.where(z < kth, -np.inf, z)
    p = np.exp(z - np.max(z[np.isfinite(z)]))
    p /= p.sum()
    if 0.0 < top_p < 1.0:
        order = np.argsort(-p)
        csum = np.cumsum(p[order])
        keep_n = int(np.searchsorted(csum, top_p) + 1)
        mask = np.zeros_like(p)
        mask[order[:keep_n]] = 1.0
        p = p * mask
        p /= p.sum()
    rng = rng if rng is not None else np.random.default_rng()
    return int(rng.choice(p.size, p=p))


# ------------------------------------------------------ device sampling

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32), in int64 without overflow
    (works on Python ints and on int64 tensors alike)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer hash finalizer (lowbias32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_uniform(seed: int, rid: torch.Tensor, index: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """[B, vocab] float32 uniforms in (0, 1), a function of (seed, rid[b],
    index[b], v) alone: integer tensor ops only, so no host sync and no
    generator state (capture-safe)."""
    h = _mix32((rid.to(torch.int64) & _M32) ^ _mix32(int(seed) & _M32))
    h = _mix32(h ^ (index.to(torch.int64) & _M32))
    v = torch.arange(1, vocab + 1, dtype=torch.int64, device=rid.device)
    x = _mix32(h[:, None] ^ _mul32(v, 0x9E3779B9)[None])
    return ((x >> 8).to(torch.float32) + 0.5) * 2.0 ** -24


def device_sample(logits: torch.Tensor, seed: int, rid: torch.Tensor,
                  index: torch.Tensor, temp: torch.Tensor, topk: torch.Tensor,
                  topp: torch.Tensor) -> torch.Tensor:
    """`sample_token` over [B, V] rows on the device: the argmax where
    temp <= 0; else temperature softmax, top-k (values below the k-th
    largest dropped) then top-p (the keep_n highest-ranked tokens, ties in
    the lowest index's favour, as numpy's argsort gives them), and one
    Gumbel-max draw from `hash_uniform(seed, rid, index)`.  int32 [B]."""
    B, V = logits.shape
    z32 = logits.to(torch.float32)
    greedy = torch.argmax(z32, -1).to(torch.int32)
    z = z32 / torch.clamp_min(temp, 1e-6)[:, None]
    zs = torch.sort(z, dim=-1, descending=True).values
    kth = torch.gather(zs, 1, torch.clamp(topk.to(torch.int64) - 1, 0, V - 1)
                       [:, None])
    z = torch.where((topk[:, None] > 0) & (z < kth), -torch.inf, z)
    p = torch.softmax(z, -1)
    order = torch.argsort(-p, dim=-1, stable=True)
    csum = torch.cumsum(torch.gather(p, 1, order), -1)
    keep_n = (csum < topp[:, None]).sum(-1) + 1
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(V, device=p.device).expand(B, V))
    use_p = (topp > 0.0) & (topp < 1.0)
    p = torch.where(use_p[:, None] & (ranks >= keep_n[:, None]), 0.0, p)
    u = hash_uniform(seed, rid, index, V)
    score = torch.log(p) - torch.log(-torch.log(u))  # log 0 = -inf: never drawn
    drawn = torch.argmax(score, -1).to(torch.int32)
    return torch.where(temp <= 0.0, greedy, drawn)


# ---------------------------------------------------------------- slots

class _Slot:
    __slots__ = ("future", "prompt", "fed", "generated", "max_new",
                 "tokens", "temperature", "top_k", "top_p", "stop_set",
                 "on_token", "rid", "rng", "finish_reason", "t_submit",
                 "t_dispatch", "t_first")

    def __init__(self, future, prompt, max_new, temperature=0.0,
                 top_k=0, top_p=0.0, stop_tokens=(), on_token=None,
                 rid=0, seed=0):
        self.future = future
        self.prompt = prompt          # np [P] int32
        self.fed = 0                  # prompt tokens already fed
        self.generated = 0
        self.max_new = max_new
        self.tokens: List[int] = []
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.stop_set = frozenset(int(t) for t in stop_tokens)
        self.on_token = on_token
        self.rid = rid                # monotone request id (sampling key)
        # per-request host RNG: draws depend only on (seed, rid, step)
        self.rng = np.random.default_rng([seed, rid])
        self.finish_reason: Optional[str] = None
        # perf_counter_ns: submitted, its admission dispatch began, first
        # token handed out
        self.t_submit = time.perf_counter_ns()
        self.t_dispatch: Optional[int] = None
        self.t_first: Optional[int] = None


class DecodeScheduler:
    # the one-hot blend rewrites the whole cache a step; beyond this many
    # rows the per-row write (the JAX package's measured crossover)
    CACHE_UPDATE_BLEND_MAX_SEQ = 512
    # width of the per-window stop-id table
    MAX_STOP_IDS = 8

    def __init__(self, cfg: TransformerConfig, batch: int = 8,
                 params: Optional[Dict[str, np.ndarray]] = None,
                 precision: str = "fp32", seed: int = 0,
                 kv_cache_dtype: str = "float32", kv_scale: float = 0.05,
                 prefill_chunk: int = 8, cache_update: str = "auto",
                 fuse_window: int = 0, weight_only: Optional[str] = None,
                 prefill_mode: str = "bucket", mesh=None,
                 cache_view: str = "auto", device=None):
        _check_mesh(mesh)
        if prefill_mode not in ("bucket", "chunked"):
            raise ValueError(f"prefill_mode {prefill_mode!r}")
        self.cfg = cfg
        self.B = batch
        self.chunk = max(1, int(prefill_chunk))
        self.fuse_window = max(0, int(fuse_window))
        self.weight_only = weight_only
        self.prefill_mode = prefill_mode
        self.device = _resolve_device(device)
        self.mesh = mesh
        self._leader = mesh is None or mesh.rank == int(mesh.devices.flat[0])
        self.token_disagreements = 0
        self.params = params if params is not None else \
            make_transformer_params(cfg, seed)
        self._seed = seed
        self._kv_scale = kv_scale
        self._precision = precision
        self._kv_cache_dtype = kv_cache_dtype
        self._weight_only_packed = {}  # weight edge -> its quantized arrays
        if cache_update == "auto":
            # distinct per-slot positions: blend or per-row writes by size
            cache_update = ("blend"
                            if cfg.max_seq <= self.CACHE_UPDATE_BLEND_MAX_SEQ
                            else "rows")
        self.cache_update = cache_update
        self.graph = self._maybe_weight_only(build_transformer_decode_step(
            cfg, batch, self.params, kv_cache_dtype=kv_cache_dtype,
            kv_scale=kv_scale, cache_update=cache_update))
        self.net = self._make_net(self.graph, shared=False)
        self._logits_edge = self.graph.outputs[0]
        self._cache_edges = [
            (self.graph.nodes[f"dec_att_{i}"].outputs[1],
             self.graph.nodes[f"dec_att_{i}"].outputs[2])
            for i in range(cfg.layers)]
        if self.chunk > 1 and prefill_mode == "chunked":
            self.vgraph = self._maybe_weight_only(build_transformer_verify_step(
                cfg, batch, self.chunk, self.params,
                kv_cache_dtype=kv_cache_dtype, kv_scale=kv_scale,
                cache_update=cache_update))
            self.vnet = self._make_net(self.vgraph)
            self._vlogits_edge = self.vgraph.outputs[0]
        # the caches in the dtype the nets compute them in, written in place
        # by every path for the scheduler's lifetime
        cdt = (torch.int8 if kv_cache_dtype == "int8" else
               torch.bfloat16 if precision == "bf16" else torch.float32)
        shape = (batch, cfg.kv_heads // self._cache_split(), cfg.max_seq,
                 cfg.head_dim)
        self._caches = {f"cache_{kv}_{i}": torch.zeros(shape, dtype=cdt,
                                                       device=self.device)
                        for i in range(cfg.layers) for kv in "kv"}
        self._pos = np.zeros((batch,), np.int32)
        self._tok = np.zeros((batch, 1), np.int32)
        self._next_rid = 0
        self._slots: List[Optional[_Slot]] = [None] * batch
        self._queue: "queue.Queue" = queue.Queue()  # submissions
        # the requests to admit: the submissions themselves, or under a mesh
        # the ones the first rank's plan named
        self._admitq = self._queue if mesh is None else queue.Queue()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._step_run = None      # the per-step decode, made at first use
        self._vrun = None          # the chunk step, made at first use
        self._fused_runs = {}      # (sampling, view) -> window step
        self._prefill_runs = {}    # bucket -> admission function
        self._prefill_graphs = {}  # bucket -> its Graph (introspection)
        self._use_views = (cache_view == "auto")
        self._view_nets = {}       # view -> (net, logits_edge, cache_edges)
        self.steps_run = 0
        self.prefill_steps_run = 0
        self.fused_windows_run = 0
        self.bucket_prefills_run = 0
        self.tokens_served = 0
        # wall seconds of fused windows, prefill and per-step decode, read
        # from the spans (module docstring)
        self.phase_seconds = {"window": 0.0, "prefill": 0.0, "step": 0.0}
        # nets built and steps captured at first use
        self.builds = {"bucket": 0, "view": 0, "window": 0, "step": 0,
                       "chunk": 0}
        self.spans = SpanRecorder()
        self._callback_ns = 0      # inside on_token and future callbacks
        self._idle_t0 = None       # the current run of idle waits began
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ----------------------------------------------------------- building
    def _compile(self, fn, feed):
        """`fn` made replayable for `feed`'s shapes, with the caches bound
        as static inputs (written in place, never copied), as `Net.compile`
        binds them for the per-step decode; eager under a mesh."""
        make = compile_step if self.mesh is None else EagerStep
        return make(fn, dict(feed, **self._caches), self._caches, self.device,
                    self.spans)

    def _cache_split(self) -> int:
        """The ranks the caches' heads split over (1: whole)."""
        if self.mesh is None:
            return 1
        from ..parallel.mesh import MODEL_AXIS

        tp = self.mesh.shape.get(MODEL_AXIS, 1)
        return tp if tp > 1 and self.cfg.kv_heads % tp == 0 else 1

    def _make_net(self, graph, shared: bool = True) -> Net:
        """A Net of `graph`, on the decode net's weights where `shared`
        (not copied); under a mesh sharded by the Megatron rules, the caches
        head-sharded and left as the rank's block, every other input whole."""
        dp = self.net.params if shared else None
        if self.mesh is None:
            return Net(graph, precision=self._precision, device=self.device,
                       device_params=dp)
        from ..parallel.mesh import MODEL_AXIS, Spec
        from ..parallel.sharding import shard_graph_params

        cache = (Spec(None, MODEL_AXIS, None, None) if self._cache_split() > 1
                 else Spec())
        specs = {k: cache if k.startswith("cache_") else Spec()
                 for k in graph.inputs}
        local = [e for n in graph.nodes.values()
                 if n.op in ("mha_decode", "mha_verify", "mha_prefill")
                 for e in n.outputs[1:]]
        return Net(graph, precision=self._precision, device=self.device,
                   device_params=dp, mesh=self.mesh,
                   param_sharding=shard_graph_params(graph, self.mesh),
                   input_shardings=specs, local_outputs=local)

    def _maybe_weight_only(self, graph):
        """weight_only None | "w8" | "w4": `weight_only_quantize` of
        `graph`, the weights quantized once for every graph (`packed`)."""
        if not self.weight_only:
            return graph
        return weight_only_quantize(
            graph, bits=4 if self.weight_only == "w4" else 8,
            packed=self._weight_only_packed)

    def cache_bytes(self) -> int:
        """Bytes of the KV arena (all slots, all layers)."""
        return sum(c.numel() * c.element_size() for c in self._caches.values())

    # ------------------------------------------------------------- public
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0, stop_tokens: Sequence[int] = (),
               on_token=None) -> Future:
        """Queue a request; resolves to np [len(prompt)+n] int32 tokens.

        `stop_tokens`: ids that end generation early (the stop token is
        the last token of the result).  `on_token(tok:int)` streams each
        generated token.  Cancel the returned future to evict the
        request (before or during generation).  Under a mesh only on its
        first rank."""
        if not self._leader:
            raise RuntimeError("submit on the mesh's first rank: it takes "
                               "the requests and plans every rank's steps")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.cfg.max_seq:
            raise ValueError(f"{len(prompt)} + {max_new_tokens} tokens exceed "
                             f"max_seq {self.cfg.max_seq}")
        if len(stop_tokens) > self.MAX_STOP_IDS:
            raise ValueError(f"at most {self.MAX_STOP_IDS} stop tokens per "
                             f"request")
        fut: Future = Future()
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
        self._queue.put(_Slot(fut, prompt, max_new_tokens,
                              temperature, top_k, top_p, stop_tokens,
                              on_token, rid, self._seed))
        self._wake.set()
        return fut

    def close(self, timeout: float = 60.0) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=timeout)

    # ------------------------------------------------------ the mesh's plan
    def _sync_plan(self) -> bool:
        """Under a mesh, once a loop: the first rank's admissions,
        cancellations and stop, on every rank (the first rank waits here
        while it has nothing to do).  False: stop."""
        if self._leader:
            if (all(s is None for s in self._slots) and self._queue.empty()
                    and not self._stop):
                self._wait_for_work()
            new = []
            while True:
                try:
                    new.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            new = [s for s in new if not s.future.cancelled()]
            plan = {"stop": self._stop,
                    "cancel": [b for b, s in enumerate(self._slots)
                               if s is not None and s.future.cancelled()],
                    "new": [(s.prompt, s.max_new, s.temperature, s.top_k,
                             s.top_p, sorted(s.stop_set), s.rid) for s in new]}
        plan = self.mesh.broadcast_object(plan if self._leader else None)
        if not self._leader:
            new = [_Slot(Future(), p, n, t, k, tp, st, None, rid, self._seed)
                   for p, n, t, k, tp, st, rid in plan["new"]]
        for s in new:
            self._admitq.put(s)
        for b in plan["cancel"]:
            self._end_request(self._slots[b], "cancelled")
            self._slots[b] = None
        return not plan["stop"]

    def _agree(self, x):
        """Under a mesh, the first rank's `x` (a step's tokens) on every
        rank, a rank whose own differs counted in `token_disagreements`."""
        if self.mesh is None:
            return x
        lead = self.mesh.broadcast_object(x if self._leader else None)
        if not np.array_equal(np.asarray(lead), np.asarray(x)):
            self.token_disagreements += 1
        return lead

    # -------------------------------------------------------------- loop
    def _wait_for_work(self) -> None:
        """Wait (at most 0.1 s) for a submission; a run of such waits is
        one `idle` span, recorded when work comes (`_end_idle`)."""
        if self._idle_t0 is None:
            self._idle_t0 = time.perf_counter_ns()
        self._wake.wait(timeout=0.1)
        self._wake.clear()

    def _end_idle(self) -> None:
        if self._idle_t0 is not None:
            self.spans.add("idle", self._idle_t0, time.perf_counter_ns())
            self._idle_t0 = None

    def _end_request(self, slot: _Slot, reason: str) -> None:
        """The request is over: its one `request` record."""
        slot.finish_reason = reason
        self.spans.add("request", slot.t_submit, time.perf_counter_ns(),
                       rid=slot.rid, dispatch=slot.t_dispatch,
                       first=slot.t_first, prompt=len(slot.prompt),
                       tokens=slot.generated, reason=reason)

    def _admit(self) -> None:
        t0 = time.perf_counter_ns()
        admitted = 0
        for b in range(self.B):
            if self._slots[b] is not None:
                continue
            while True:
                try:
                    req = self._admitq.get_nowait()
                except queue.Empty:
                    req = None
                    break
                # under a mesh a cancellation takes effect through the plan
                if self.mesh is not None or not req.future.cancelled():
                    break
                self._end_request(req, "cancelled")
            if req is None:
                break
            self._slots[b] = req
            # the slot restarts at position 0 (rows past pos are never read)
            self._pos[b] = 0
            req.fed = 0
            admitted += 1
        if admitted:
            self.spans.add("admit", t0, time.perf_counter_ns(),
                           slots=admitted)

    def _reap_cancelled(self) -> None:
        """Evict slots whose future was cancelled."""
        for b, slot in enumerate(self._slots):
            if slot is not None and slot.future.cancelled():
                self._end_request(slot, "cancelled")
                self._slots[b] = None

    def _finish(self, b: int, slot: _Slot, reason: str = "length") -> None:
        self._end_request(slot, reason)
        self._slots[b] = None
        if slot.future.cancelled():
            return
        t0 = time.perf_counter_ns()
        try:
            slot.future.set_result(
                np.concatenate([slot.prompt,
                                np.asarray(slot.tokens, np.int32)]))
        except Exception:                       # racing cancel
            pass
        self._callback_ns += time.perf_counter_ns() - t0

    def _emit(self, slot: _Slot, tok: int) -> None:
        slot.tokens.append(tok)
        slot.generated += 1
        self.tokens_served += 1
        if slot.generated == 1:
            slot.t_first = time.perf_counter_ns()
        if slot.on_token is not None:
            t0 = time.perf_counter_ns()
            try:
                slot.on_token(tok)
            except Exception:                   # a stream sink must not
                _log.exception("on_token callback failed")  # stop serving
            self._callback_ns += time.perf_counter_ns() - t0

    def _sample_and_store(self, picks) -> None:
        """Sample each (slot index, slot, logit row) of a step, agree on
        the tokens across the mesh, store them."""
        toks = self._agree([sample_token(row, slot.temperature, slot.top_k,
                                         slot.top_p, slot.rng)
                            for _, slot, row in picks])
        for (b, slot, _), nxt in zip(picks, toks):
            self._store(b, slot, int(nxt))

    def _store(self, b: int, slot: _Slot, nxt: int) -> None:
        self._emit(slot, nxt)
        if nxt in slot.stop_set:
            self._finish(b, slot, "stop")
        elif slot.generated >= slot.max_new:
            self._finish(b, slot, "length")
        else:
            self._tok[b, 0] = nxt

    def _fail_active(self, exc: BaseException) -> None:
        """A device step failed: its caches may hold a partial write, so the
        in-flight requests cannot go on.  Fail their futures, zero the
        caches in place (captured graphs keep their addresses), go on
        serving."""
        _log.exception("device step failed; resetting scheduler arena",
                       exc_info=exc)
        failed = [s for s in self._slots if s is not None]
        for slot in failed:
            self._end_request(slot, "failed")
        self._slots = [None] * self.B
        for c in self._caches.values():
            c.zero_()
        self._pos[:] = 0
        self._tok[:] = 0
        # the arena is reset before a caller sees the failure
        for slot in failed:
            if not slot.future.cancelled():
                try:
                    slot.future.set_exception(exc)
                except Exception:
                    pass

    def _step_decode(self) -> None:
        """One single-token step: every active slot decodes (or, when
        chunk == 1, teacher-forces its next prompt token)."""
        feed = dict(self._caches, input=self._tok.copy(), pos=self._pos.copy())
        try:
            if self._step_run is None:
                net = self.net
                with self.spans.span("step.build"):
                    self._step_run = self._compile(
                        lambda x: net.forward(net.params, x, net.prepared),
                        feed)
                self.builds["step"] += 1
            out = self._step_run(feed)
            logits = out[self._logits_edge].to(torch.float32).cpu().numpy()
        except Exception as e:
            self._fail_active(e)
            return
        self.steps_run += 1
        picks = []
        for b, slot in enumerate(self._slots):
            if slot is None:
                continue
            self._pos[b] += 1
            if slot.fed < len(slot.prompt):
                self._tok[b, 0] = slot.prompt[slot.fed]
                slot.fed += 1
                # once fed == len(prompt), the next step's logits give the
                # first sampled token
                continue
            picks.append((b, slot, logits[b, 0]))
        self._sample_and_store(picks)

    # -------------------------------------------------- bucketed admission
    def _bucket(self, P: int) -> int:
        return prefill_bucket(P, self.cfg.max_seq)

    def _make_prefill_run(self, L: int):
        """The admission for bucket length L: the cache-emitting prefill
        graph over the whole slot batch (`last_token_only`: logits of each
        slot's last real position only), then each admitted slot's cache
        rows copied into the live caches in place.  Bucket padding needs no
        mask: causal attention keeps row nreal-1 from rows >= nreal, and
        the cache rows past nreal are written before any step reads them.
        Returns run(ids, nreal, slots) -> [B, V] float32 logits (numpy)."""
        g = self._maybe_weight_only(build_transformer_prefill(
            self.cfg, self.B, L, self.params,
            kv_cache_dtype=self._kv_cache_dtype, kv_scale=self._kv_scale,
            attention_impl=prefill_attention_impl(
                self.device, L, self.cfg.head_dim, self._precision),
            last_token_only=True))
        self._prefill_graphs[L] = g
        pnet = self._make_net(g)
        logits_e = g.outputs[0]
        edges = {f"cache_{kv}_{i}": g.nodes[f"pre_att_{i}"].outputs[1 + j]
                 for i in range(self.cfg.layers) for j, kv in enumerate("kv")}

        def run(ids, nreal, slots):
            feed = {"input": ids, "nreal": nreal}
            with self.spans.span("admission.enqueue"):
                if self.mesh is None:
                    out = pnet.prediction(feed)
                else:  # the caches stay the rank's heads
                    with torch.inference_mode():
                        out = pnet.forward(pnet.params, {
                            k: torch.from_numpy(v).to(self.device)
                            for k, v in feed.items()}, pnet.prepared)
                idx = torch.as_tensor(slots, dtype=torch.int64,
                                      device=self.device)
                for name, e in edges.items():
                    cache = self._caches[name]
                    cache[idx] = out[e][idx].to(cache.dtype)
                logits = out[logits_e][:, 0, :].to(torch.float32)
            with self.spans.span("admission.readback"):
                return logits.cpu().numpy()

        return run

    def _step_prefill_bucket(self) -> None:
        """Admit every pending prompt: one dispatch per distinct bucket
        fills the admitted slots' caches and gives their first sampled
        token.  Decoding slots wait for it (they go on at the next step)."""
        pending = {}
        for b, slot in enumerate(self._slots):
            if slot is not None and slot.fed < len(slot.prompt):
                pending.setdefault(self._bucket(len(slot.prompt)),
                                   []).append(b)
        for L, slots_b in sorted(pending.items()):
            ids = np.zeros((self.B, L), np.int32)
            nreal = np.ones((self.B,), np.int32)
            for b in slots_b:
                prompt = self._slots[b].prompt
                ids[b, :len(prompt)] = prompt
                nreal[b] = len(prompt)
            with self.spans.span("admission", L=L, slots=len(slots_b),
                                 rows_real=int(nreal[slots_b].sum()),
                                 rows_launched=self.B * L) as adm:
                for b in slots_b:
                    self._slots[b].t_dispatch = adm.t0
                try:
                    run = self._prefill_runs.get(L)
                    if run is None:
                        with self.spans.span("admission.build"):
                            run = self._make_prefill_run(L)
                        self._prefill_runs[L] = run
                        self.builds["bucket"] += 1
                    rows = run(ids, nreal, slots_b)  # the dispatch's one fetch
                except Exception as e:
                    self._fail_active(e)
                    return
                with self.spans.span("admission.emit") as em:
                    cb0 = self._callback_ns
                    self.steps_run += 1
                    self.prefill_steps_run += 1
                    self.bucket_prefills_run += 1
                    picks = []
                    for b in slots_b:
                        slot = self._slots[b]
                        if slot is None:
                            continue
                        P = len(slot.prompt)
                        slot.fed = P
                        self._pos[b] = P
                        picks.append((b, slot, rows[b]))
                    self._sample_and_store(picks)
                    em.attrs["callback_ns"] = self._callback_ns - cb0
            self.phase_seconds["prefill"] += (em.t0 - adm.t0) * 1e-9

    # ------------------------------------------------------ chunked prefill
    def _make_vrun(self, feed):
        """The chunk step with the logit rows gathered on the device: only
        row nreal[b] - 1 of each slot comes back, [B, V]."""
        vnet, vlog, B = self.vnet, self._vlogits_edge, self.B
        names = [*self._caches, "input", "pos"]

        def fn(x):
            out = vnet.forward(vnet.params, {k: x[k] for k in names},
                               vnet.prepared)
            rows = out[vlog][torch.arange(B, device=self.device),
                             x["nreal"].to(torch.int64) - 1]
            return {"rows": rows.to(torch.float32)}

        return self._compile(fn, feed)

    def _step_prefill(self) -> None:
        """One chunk step through the verify net: prefilling slots feed up
        to `chunk` prompt tokens; decoding slots feed their one token plus
        padding (pad rows are written before the position reaches them)."""
        K = self.chunk
        ids = np.zeros((self.B, K), np.int32)
        nreal = np.zeros((self.B,), np.int32)
        for b, slot in enumerate(self._slots):
            if slot is None:
                nreal[b] = 1  # keeps the gather index (nreal - 1) in range
                continue
            if slot.fed < len(slot.prompt):
                n = min(K, len(slot.prompt) - slot.fed)
                ids[b, :n] = slot.prompt[slot.fed: slot.fed + n]
                nreal[b] = n
            else:
                ids[b, 0] = self._tok[b, 0]
                nreal[b] = 1
        feed = {"input": ids, "pos": self._pos.copy(), "nreal": nreal}
        try:
            if self._vrun is None:
                with self.spans.span("chunk.build"):
                    self._vrun = self._make_vrun(feed)
                self.builds["chunk"] += 1
            rows = self._vrun(feed)["rows"].cpu().numpy()  # the chunk's fetch
        except Exception as e:
            self._fail_active(e)
            return
        self.steps_run += 1
        self.prefill_steps_run += 1
        picks = []
        for b, slot in enumerate(self._slots):
            if slot is None:
                continue
            n = int(nreal[b])
            self._pos[b] += n
            if slot.fed < len(slot.prompt):
                slot.fed += n
                if slot.fed >= len(slot.prompt):
                    # the last prompt token's logits give the first sample
                    picks.append((b, slot, rows[b]))
                continue
            picks.append((b, slot, rows[b]))
        self._sample_and_store(picks)

    # ------------------------------------------------------- fused window
    def _can_fuse(self) -> bool:
        """A window fuses when every active slot is past its prompt."""
        if self.fuse_window <= 1:
            return False
        active = [s for s in self._slots if s is not None]
        return bool(active) and all(
            s.fed >= len(s.prompt) for s in active)

    def _window_fn(self, K: int, sampling: bool, view: int = 0):
        """The eager window: K decode steps chained on the device over the
        view's decode net, carrying (tok, pos, alive) with the JAX
        window's masking (per-slot budgets `rem`, stop ids, frozen slots).
        fn(inputs) -> {"packed": [K+1, B] int32}: the K steps' tokens, then
        k_done, the steps in which some slot had work.  The inputs hold the
        caches, as every step of the scheduler takes them."""
        net, logits_e, _ = self._net_for_view(view)
        B, seed, caches = self.B, self._seed, list(self._caches)

        def fn(x):
            tok, pos, rem = x["tok"], x["pos"], x["rem"]
            alive = torch.ones((B,), dtype=torch.bool, device=tok.device)
            k_done = torch.zeros((), dtype=torch.int32, device=tok.device)
            rows = []
            for k in range(K):
                active = alive & (rem > k)
                k_done = k_done + active.any().to(torch.int32)
                out = net.forward(net.params,
                                  dict({c: x[c] for c in caches}, input=tok,
                                       pos=pos), net.prepared)
                logits = out[logits_e][:, 0, :]
                if sampling:
                    nxt = device_sample(logits, seed, x["rid"], x["gen0"] + k,
                                        x["temp"], x["topk"], x["topp"])
                else:
                    nxt = torch.argmax(logits.to(torch.float32),
                                       -1).to(torch.int32)
                stop_now = (nxt[:, None] == x["stop_ids"]).any(1)
                tok = torch.where(active[:, None], nxt[:, None], tok)
                pos = torch.where(active, pos + 1, pos)
                alive = alive & ~(active & stop_now)
                rows.append(nxt)
            rows.append(k_done.expand(B))
            return {"packed": torch.stack(rows)}

        return fn

    def _net_for_view(self, view: int):
        """The decode Net whose attention reads only the first `view` cache
        rows (0: all of them), on the shared weights."""
        if view <= 0 or view >= self.cfg.max_seq:
            return self.net, self._logits_edge, self._cache_edges
        ent = self._view_nets.get(view)
        if ent is None:
            g = self._maybe_weight_only(build_transformer_decode_step(
                self.cfg, self.B, self.params,
                kv_cache_dtype=self._kv_cache_dtype, kv_scale=self._kv_scale,
                cache_update=self.cache_update, cache_view=view))
            edges = [(g.nodes[f"dec_att_{i}"].outputs[1],
                      g.nodes[f"dec_att_{i}"].outputs[2])
                     for i in range(self.cfg.layers)]
            ent = (self._make_net(g), g.outputs[0], edges)
            self._view_nets[view] = ent
            self.builds["view"] += 1
        return ent

    def _view_bucket(self, need: int) -> int:
        """Smallest ladder bucket (128, 256, ... doubling) covering `need`
        rows; 0 = the full cache when the ladder tops out."""
        if not self._use_views:
            return 0
        v = 128
        while v < need:
            v *= 2
        return 0 if v >= self.cfg.max_seq else v

    def _step_fused(self) -> None:
        """One fused window of up to K steps (one dispatch)."""
        K = self.fuse_window
        rem = np.zeros((self.B,), np.int32)
        temp = np.zeros((self.B,), np.float32)
        topk = np.zeros((self.B,), np.int32)
        topp = np.zeros((self.B,), np.float32)
        rid = np.zeros((self.B,), np.int32)
        gen0 = np.zeros((self.B,), np.int32)
        stop_ids = np.full((self.B, self.MAX_STOP_IDS), -1, np.int32)
        for b, slot in enumerate(self._slots):
            if slot is not None:
                rem[b] = min(K, slot.max_new - slot.generated)
                temp[b] = slot.temperature
                topk[b] = slot.top_k
                topp[b] = slot.top_p
                rid[b] = slot.rid
                gen0[b] = slot.generated
                for j, t in enumerate(sorted(slot.stop_set)):
                    stop_ids[b, j] = t
        sampling = bool((temp > 0.0).any())
        # every active slot stays below pos + rem <= view in this window
        need = int(max((int(self._pos[b]) + int(rem[b])
                        for b in range(self.B) if self._slots[b] is not None),
                       default=0))
        view = self._view_bucket(need)
        feed = dict(tok=self._tok.copy(), pos=self._pos.copy(), rem=rem,
                    rid=rid, gen0=gen0, temp=temp, topk=topk, topp=topp,
                    stop_ids=stop_ids)
        active = sum(s is not None for s in self._slots)
        with self.spans.span("window", view=view, K=K,
                             active=active) as win:
            try:
                run = self._fused_runs.get((sampling, view))
                if run is None:
                    with self.spans.span("window.build"):
                        run = self._compile(self._window_fn(K, sampling, view),
                                            feed)
                    self._fused_runs[(sampling, view)] = run
                    self.builds["window"] += 1
                with self.spans.span("window.launch"):
                    out = run(feed)["packed"]
                with self.spans.span("window.readback"):
                    packed = self._agree(out.cpu().numpy())
            except Exception as e:
                self._fail_active(e)
                return
            with self.spans.span("window.emit") as em:
                cb0 = self._callback_ns
                toks, k_done = packed[:-1], int(packed[-1, 0])
                win.attrs["k_done"] = k_done
                self.steps_run += k_done
                self.fused_windows_run += 1
                self._emit_window(toks, k_done, rem)
                em.attrs["callback_ns"] = self._callback_ns - cb0
        self.phase_seconds["window"] += (em.t0 - win.t0) * 1e-9

    def _emit_window(self, toks: np.ndarray, k_done: int,
                     rem: np.ndarray) -> None:
        """A window's [K, B] tokens handed out: the host mirrors advance as
        the device masking did (a slot is active for steps 0..n-1, n =
        min(rem, first stop + 1), and k_done >= n for every slot)."""
        for b in range(self.B):
            slot = self._slots[b]
            if slot is None:
                continue
            n_active = 0
            stopped = False
            for t in range(min(int(rem[b]), k_done)):
                n_active += 1
                if int(toks[t, b]) in slot.stop_set:
                    stopped = True
                    break
            self._pos[b] += n_active
            if n_active > 0:
                self._tok[b, 0] = toks[n_active - 1, b]
            for t in range(n_active):
                self._emit(slot, int(toks[t, b]))
                if stopped and t == n_active - 1:
                    self._finish(b, slot, "stop")
                    break
                if slot.generated >= slot.max_new:
                    self._finish(b, slot, "length")
                    break

    def _loop(self) -> None:
        on_card = (torch.cuda.device(self.device) if self.device.type == "cuda"
                   else contextlib.nullcontext())
        with on_card, torch.inference_mode():
            while True:
                if self.mesh is None:
                    if self._stop:
                        break
                    self._reap_cancelled()
                    if all(s is None for s in self._slots) \
                            and self._queue.empty():
                        self._wait_for_work()
                        continue
                elif not self._sync_plan():
                    break
                if any(s is not None for s in self._slots) \
                        or not self._admitq.empty():
                    self._end_idle()
                self._admit()
                if all(s is None for s in self._slots):
                    continue
                prefilling = any(s is not None and s.fed < len(s.prompt)
                                 for s in self._slots)
                if prefilling and self.prefill_mode == "bucket":
                    self._step_prefill_bucket()
                elif prefilling and self.chunk > 1:
                    self._timed("chunk", "prefill", self._step_prefill)
                elif self._can_fuse():
                    self._step_fused()
                else:
                    self._timed("step", "step", self._step_seeded)
        self._end_idle()
        # drain on close
        for slot in self._slots:
            if slot is not None and not slot.future.done():
                self._end_request(slot, "cancelled")
                slot.future.cancel()

    def _timed(self, name: str, phase: str, fn) -> None:
        """`fn()` as one top-level span, its time added to `phase`; the
        requests it feeds for the first time dispatched at its start."""
        with self.spans.span(name) as sp:
            for s in self._slots:
                if s is not None and s.t_dispatch is None:
                    s.t_dispatch = sp.t0
            fn()
        self.phase_seconds[phase] += sp.seconds

    def _step_seeded(self) -> None:
        if not (self.chunk > 1 and self.prefill_mode == "chunked"):
            # the per-step path (fuse_window <= 1, or chunk 1): seed first
            # tokens where needed
            for b, s in enumerate(self._slots):
                if s is not None and s.fed == 0:
                    self._tok[b, 0] = s.prompt[0]
                    s.fed = 1
        self._step_decode()
