"""Speculative decoding: draft-model proposals verified in target chunks, the
port of `anakin_tpu/runtime/speculative.py`.

Greedy speculative decoding is exact: the tokens are those of greedy
decoding with the target model alone; the draft only changes how many
target steps they take.  A round:

  1. the draft proposes `k` tokens (k single-token decode steps);
  2. the target scores [committed token, d_1 .. d_k] in one verify chunk at
     positions pos .. pos+k (`build_transformer_verify_step`), writing
     those cache rows;
  3. the longest prefix of drafts equal to the target's own argmax is
     accepted, and the target's token at the first mismatch comes with it,
     so a round commits 1 to k+1 tokens;
  4. rejected rows stay in both caches, are never attended (each token
     attends the rows up to its own position) and are overwritten by the
     next round's writes.

Three loops give the same tokens:

  * `generate`: the host loop, one decode step or verify chunk at a time,
    with `adaptive_k` (k doubles after a fully accepted round and halves
    after a round that accepted nothing);
  * `generate_round_fused`: a round (k draft steps, the verify chunk and
    the acceptance on the device) is one captured CUDA graph per k
    (`runtime/graphs.py`); the host reads the round's commit and `a` once a
    round;
  * `generate_fused`: the JAX package runs the whole generation as one
    `lax.while_loop`.  A CUDA graph has no data-dependent loop, so here a
    captured graph runs a window of `WINDOW_ROUNDS` rounds, each masked by
    `ptr < N`: a round after the last one changes nothing that is returned
    (its cache rows lie past every committed position), as the decode
    scheduler's frozen slots do.  The host reads the window's rounds once
    a window and replays windows until `ptr >= N`; `rounds` and `accepted`
    count the live rounds, as the JAX loop counts its iterations.

On CUDA both captured paths bind the two models' caches as static inputs,
written in place by the graph (the session keeps one set and copies each
prefill's caches into it); on the CPU the same steps run eagerly.  The
capture's warm-up runs the first round or window once for real; the replay
then recomputes it from the same inputs and writes the same rows with the
same values, since no round reads a row before writing it.

The prefill is exact-length (`prefill_buckets=False`): a bucket's padding
moves the prefill's float sums and flips near-tie argmaxes between the
draft and verify paths.  So `prefill_attention="auto"` takes the flash
kernel for a prompt of 512 tokens or more on CUDA.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models.transformer import (
    TransformerConfig,
    build_transformer_verify_step,
    make_transformer_params,
)
from .generate import GenerationSession
from .graphs import compile_step
from .net import Net, _resolve_device

__all__ = ["SpeculativeSession"]


class SpeculativeSession:
    """Greedy speculative decoding at batch 1 with a small draft model:

        s = SpeculativeSession(cfg, draft_cfg, k=4, precision="bf16",
                               kv_cache_dtype="int8")       # on CUDA
        tokens = s.generate(prompt, max_new_tokens=64)      # [1, P + 64]

    `device=None` means CUDA and raises where there is none; pass
    `device="cpu"` for the CPU.  The draft's params default to
    `make_transformer_params(draft_cfg, seed + 1)`; its KV cache is float,
    as in the JAX package.  The verify nets share the target decode net's
    weights on the device.
    """

    # rounds in one captured window of `generate_fused`
    WINDOW_ROUNDS = 8

    def __init__(self, cfg: TransformerConfig, draft_cfg: TransformerConfig,
                 params: Optional[Dict[str, np.ndarray]] = None,
                 draft_params: Optional[Dict[str, np.ndarray]] = None,
                 k: int = 4, precision: str = "fp32", seed: int = 0,
                 kv_cache_dtype: str = "float32", kv_scale: float = 0.05,
                 device=None):
        self.k = int(k)
        self.device = _resolve_device(device)
        self._kv_cache_dtype = kv_cache_dtype
        self._kv_scale = kv_scale
        self._precision = precision
        self.target = GenerationSession(
            cfg, batch=1, params=params, precision=precision, seed=seed,
            kv_cache_dtype=kv_cache_dtype, kv_scale=kv_scale,
            prefill_buckets=False, device=self.device)
        self.draft = GenerationSession(
            draft_cfg, batch=1,
            params=(draft_params if draft_params is not None
                    else make_transformer_params(draft_cfg, seed + 1)),
            prefill_buckets=False, precision=precision, device=self.device)
        self.verify_graph = build_transformer_verify_step(
            cfg, 1, self.k + 1, self.target.params,
            kv_cache_dtype=kv_cache_dtype, kv_scale=kv_scale)
        self.verify_net = Net(self.verify_graph, precision=precision,
                              device=self.device,
                              device_params=self.target.decode_net.params)
        self.rounds = 0
        self.tokens_committed = 0
        self.drafts_accepted = 0
        self.drafts_proposed = 0
        self._verify_nets = {self.k: (self.verify_net, self.verify_graph)}
        self._round_runs = {}   # k -> the captured round
        self._window_runs = {}  # (k, rounds) -> the captured window
        self._caches = None     # the caches the captured steps bind

    # ------------------------------------------------------------ helpers
    def _verify_net_for(self, k: int):
        """The verify net of chunk k + 1 (one per distinct k of adaptive
        rounds), on the target's weights."""
        ent = self._verify_nets.get(k)
        if ent is None:
            g = build_transformer_verify_step(
                self.target.cfg, 1, k + 1, self.target.params,
                kv_cache_dtype=self._kv_cache_dtype, kv_scale=self._kv_scale)
            ent = (Net(g, precision=self._precision, device=self.device,
                       device_params=self.verify_net.params), g)
            self._verify_nets[k] = ent
        return ent

    def _verify(self, tokens: torch.Tensor, pos: int, caches, k: int):
        """tokens [1, k+1]: the committed token and k drafts.  Returns the
        target's argmax at each position (numpy [k+1]) and the caches."""
        net, graph = self._verify_net_for(k)
        feed = dict(caches)
        feed["input"] = tokens
        feed["pos"] = torch.full((1,), pos, dtype=torch.int32,
                                 device=self.device)
        out = net.prediction(feed)
        nxt = torch.argmax(out[graph.outputs[0]][0], dim=-1)
        new_caches = {}
        for i in range(self.target.cfg.layers):
            node = graph.nodes[f"ver_att_{i}"]
            new_caches[f"cache_k_{i}"] = out[node.outputs[1]]
            new_caches[f"cache_v_{i}"] = out[node.outputs[2]]
        return nxt.to(torch.int32).cpu().numpy(), new_caches

    def _check(self, prompt, max_new_tokens: int, k_top: int) -> torch.Tensor:
        prompt = torch.as_tensor(np.asarray(prompt)).to(self.device,
                                                        torch.int32)
        B, P = prompt.shape
        if B != 1:
            raise ValueError("speculative decoding is the batch-1 latency "
                             f"path; the prompt has batch {B}")
        if P + max_new_tokens + k_top + 1 > self.target.cfg.max_seq:
            raise ValueError(f"{P} + {max_new_tokens} + {k_top} + 1 tokens "
                             f"exceed max_seq {self.target.cfg.max_seq}")
        return prompt

    @staticmethod
    def _tokens(prompt: torch.Tensor, committed, n: int) -> np.ndarray:
        out = np.array(committed[:n], np.int32)[None]
        return np.concatenate([prompt.cpu().numpy(), out], axis=1)

    @property
    def acceptance_rate(self) -> float:
        drafted = self.drafts_proposed or self.rounds * self.k
        return self.drafts_accepted / drafted if drafted else 0.0

    # ---------------------------------------------------------- host loop
    def generate(self, prompt, max_new_tokens: int = 16,
                 adaptive_k: bool = False, k_min: int = 1,
                 k_max: int = 8) -> np.ndarray:
        """prompt [1, P] int -> [1, P + max_new_tokens] int32 (numpy), the
        tokens of `GenerationSession.generate`.  `adaptive_k`: a fully
        accepted round doubles k (up to k_max), a round that accepted
        nothing halves it (down to k_min); one verify net per k."""
        prompt = self._check(prompt, max_new_tokens,
                             k_max if adaptive_k else self.k)
        P = prompt.shape[1]
        t_logits, t_caches = self.target._prefill(prompt)
        _, d_caches = self.draft._prefill(prompt)
        committed = [int(torch.argmax(t_logits[0, 0]))]
        pos = P
        k = self.k
        while len(committed) < max_new_tokens:
            drafts = []
            cur = committed[-1]
            for dpos in range(pos, pos + k):
                d_logits, d_caches = self.draft._step(
                    torch.tensor([cur], dtype=torch.int32,
                                 device=self.device), dpos, d_caches)
                cur = int(torch.argmax(d_logits[0, 0]))
                drafts.append(cur)
            chunk = torch.tensor([[committed[-1]] + drafts],
                                 dtype=torch.int32, device=self.device)
            nxt, t_caches = self._verify(chunk, pos, t_caches, k)
            a = 0
            while (a < k and nxt[a] == drafts[a]
                   and len(committed) + a + 1 < max_new_tokens):
                a += 1
            committed.extend(drafts[:a])
            if len(committed) < max_new_tokens:
                committed.append(int(nxt[a]))
            pos += a + 1
            self.rounds += 1
            self.drafts_accepted += a
            self.drafts_proposed += k
            self.tokens_committed += a + 1
            if adaptive_k:
                k = (min(k * 2, k_max) if a == k else
                     max(k // 2, k_min) if a == 0 else k)
        return self._tokens(prompt, committed, max_new_tokens)

    # ------------------------------------------------------- device rounds
    def _prefill_bound(self, prompt: torch.Tensor):
        """Both prefills, their caches copied into the set the captured
        steps bind (allocated at first use).  Returns the target's first
        token ([1] int32 on the device) and the feed of caches."""
        t_logits, t_caches = self.target._prefill(prompt)
        _, d_caches = self.draft._prefill(prompt)
        fresh = {**{"t_" + n: c for n, c in t_caches.items()},
                 **{"d_" + n: c for n, c in d_caches.items()}}
        if self._caches is None:
            self._caches = {n: c.clone() for n, c in fresh.items()}
        else:
            for n, c in fresh.items():
                self._caches[n].copy_(c)
        t0 = torch.argmax(t_logits[0, 0]).to(torch.int32).reshape(1)
        return t0, self._caches

    def _round(self, k: int):
        """round(x, cur, pos) -> (commit [k+1], a, the target's token at a
        [1]) on the device, with no host sync: k draft steps from `cur` at
        `pos`, the verify chunk, the acceptance.  `x` holds the caches
        ("t_cache_k_0", ..., "d_cache_k_0", ...), written in place."""
        tnet, tgraph = self._verify_net_for(k)
        dnet, dgraph = self.draft.decode_net, self.draft.decode_graph
        t_logits_e, d_logits_e = tgraph.outputs[0], dgraph.outputs[0]
        t_att = [tgraph.nodes[f"ver_att_{i}"]
                 for i in range(self.target.cfg.layers)]
        d_att = [dgraph.nodes[f"dec_att_{i}"]
                 for i in range(self.draft.cfg.layers)]

        def caches(x, prefix, att):
            feed = {}
            for i in range(len(att)):
                feed[f"cache_k_{i}"] = x[f"{prefix}cache_k_{i}"]
                feed[f"cache_v_{i}"] = x[f"{prefix}cache_v_{i}"]
            return feed

        def run(x, cur, pos):
            dfeed = caches(x, "d_", d_att)
            tok, dpos, drafts = cur, pos, []
            for _ in range(k):
                out = dnet.forward(dnet.params, dict(
                    dfeed, input=tok.reshape(1, 1), pos=dpos), dnet.prepared)
                tok = torch.argmax(out[d_logits_e][0, 0]).to(
                    torch.int32).reshape(1)
                for i, node in enumerate(d_att):
                    dfeed[f"cache_k_{i}"] = out[node.outputs[1]]
                    dfeed[f"cache_v_{i}"] = out[node.outputs[2]]
                drafts.append(tok)
                dpos = dpos + 1
            drafts = torch.cat(drafts)
            out = tnet.forward(tnet.params, dict(
                caches(x, "t_", t_att),
                input=torch.cat([cur, drafts]).reshape(1, k + 1), pos=pos),
                tnet.prepared)
            nxt = torch.argmax(out[t_logits_e][0], dim=-1).to(torch.int32)
            match = torch.cat([nxt[:k] == drafts,
                               torch.zeros(1, dtype=torch.bool,
                                           device=nxt.device)])
            a = torch.argmin(match.to(torch.int32))  # first mismatch, or k
            padded = torch.cat([drafts, torch.zeros(1, dtype=torch.int32,
                                                    device=nxt.device)])
            idx = torch.arange(k + 1, device=nxt.device)
            nxt_a = nxt.index_select(0, a.reshape(1))  # not nxt[a]: a sync
            commit = torch.where(idx == a, nxt_a, padded)
            return commit, a, nxt_a

        return run

    def _round_step(self, k: int):
        """The step of `generate_round_fused`: one round from inputs "cur"
        and "pos" -> {"packed": [commit (k+1), a]}."""
        round_ = self._round(k)

        def fn(x):
            commit, a, _ = round_(x, x["cur"], x["pos"])
            return {"packed": torch.cat([commit, a.reshape(1).to(torch.int32)])}

        return fn

    def _window_step(self, k: int, R: int):
        """The step of `generate_fused`: R rounds from inputs "cur", "pos",
        "ptr" and "n_new", each round live while ptr < n_new (a round that
        is not live changes nothing the step returns) -> {"packed":
        [R + 1, k + 3]}: each round's commit, a and liveness, then the
        final cur, pos and ptr."""
        round_ = self._round(k)

        def fn(x):
            cur, pos, ptr, n = x["cur"], x["pos"], x["ptr"], x["n_new"]
            rows = []
            for _ in range(R):
                commit, a, nxt_a = round_(x, cur, pos)
                live = ptr < n
                step = (a + 1).to(torch.int32)
                ptr = torch.where(live, ptr + step, ptr)
                pos = torch.where(live, pos + step, pos)
                cur = torch.where(live, nxt_a, cur)
                rows.append(torch.cat([commit, a.reshape(1).to(torch.int32),
                                       live.to(torch.int32)]))
            rows.append(torch.cat([cur, pos, ptr, torch.zeros(
                k, dtype=torch.int32, device=cur.device)]))
            return {"packed": torch.stack(rows)}

        return fn

    def _compile(self, fn, feed):
        """`fn` made replayable for `feed`'s shapes, the caches bound as
        static inputs."""
        return compile_step(fn, feed, self._caches, self.device)

    def generate_round_fused(self, prompt,
                             max_new_tokens: int = 16) -> np.ndarray:
        """The tokens of `generate`, one device round (one CUDA-graph
        replay on CUDA) at a time; the host reads the round's commit and
        its accepted count `a` once a round.  One captured round serves
        every prompt length and position."""
        k = self.k
        prompt = self._check(prompt, max_new_tokens, k)
        N = int(max_new_tokens)
        t0, feed = self._prefill_bound(prompt)
        committed = [int(t0)]
        pos = prompt.shape[1]
        run = self._round_runs.get(k)
        while len(committed) < N:
            inputs = dict(feed, cur=np.array([committed[-1]], np.int32),
                          pos=np.array([pos], np.int32))
            if run is None:
                run = self._round_runs[k] = self._compile(
                    self._round_step(k), inputs)
            packed = run(inputs)["packed"].cpu().numpy()  # the round's fetch
            commit, a = packed[:k + 1], int(packed[k + 1])
            take = min(a + 1, N - len(committed))
            committed.extend(int(t) for t in commit[:take])
            pos += a + 1
            self.rounds += 1
            self.drafts_proposed += k
            # commit[:take] are all drafts unless the target's token (index
            # a) made the cut, i.e. unless take == a + 1
            self.drafts_accepted += a if take == a + 1 else take
            self.tokens_committed += take
        return self._tokens(prompt, committed, N)

    def generate_fused(self, prompt, max_new_tokens: int = 16) -> np.ndarray:
        """The tokens of `generate`, `WINDOW_ROUNDS` device rounds (one
        CUDA-graph replay on CUDA) at a time, each masked by `ptr < N`; the
        host reads the window once, then replays the next while `ptr < N`.
        One captured window serves every prompt length and N."""
        k, R = self.k, int(self.WINDOW_ROUNDS)
        prompt = self._check(prompt, max_new_tokens, k)
        N = int(max_new_tokens)
        t0, feed = self._prefill_bound(prompt)
        committed = []
        state = dict(cur=t0, pos=np.array([prompt.shape[1]], np.int32),
                     ptr=np.array([1], np.int32))
        rounds = accepted = 0
        run = self._window_runs.get((k, R))
        ptr = 1
        while ptr < N:
            inputs = dict(feed, n_new=np.array([N], np.int32), **state)
            if run is None:
                run = self._window_runs[(k, R)] = self._compile(
                    self._window_step(k, R), inputs)
            packed = run(inputs)["packed"].cpu().numpy()  # the window's fetch
            for row in packed[:R]:
                if row[k + 2]:
                    a = int(row[k + 1])
                    rounds += 1
                    accepted += a
                    committed.extend(int(t) for t in row[:a + 1])
            cur, pos, ptr = (int(v) for v in packed[R, :3])
            state = dict(cur=np.array([cur], np.int32),
                         pos=np.array([pos], np.int32),
                         ptr=np.array([ptr], np.int32))
        self.rounds += rounds
        self.drafts_accepted += accepted
        self.drafts_proposed += rounds * k
        self.tokens_committed += N
        return self._tokens(prompt, [int(t0)] + committed, N)
