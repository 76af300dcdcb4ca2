"""The port's `DecodeScheduler` against the JAX package's on the CPU.

Each test runs the JAX scheduler and the port's (`device="cpu"`) on the
same params (`make_transformer_params`, seed 5) and the same seeded
prompts, at the JAX tests' size (vocab 40, E 64, 4 heads over 2, 2 layers,
max_seq 32-320), and requires:

  * greedy tokens equal, request for request (both compute in float32; the
    port's sums run in another order, well below any top-2 gap here);
  * the same scheduling: `steps_run`, `prefill_steps_run`,
    `fused_windows_run`, `bucket_prefills_run`, the buckets built, each
    window's `k_done` (the
    JAX `while_loop`'s count of steps with work; the port's window always
    runs its K steps and reports the same count) and `cache_bytes()`.

Both schedulers' first admission is held until every request is queued,
so that the two see the same batches.  Device sampling has no JAX
counterpart to compare with (the port hashes (seed, request id, token
index) where the JAX package folds PRNG keys), so its tests check
properties: top_k = 1 is the argmax, a request draws the same tokens alone
and in a full batch, and the draws follow the filtered distribution
(chi-square).  `sample_token`, the host paths' sampler, is held bit-equal
to the JAX one.
"""

import threading

import numpy as np
import pytest
import torch

from anakin_tpu.models import transformer as jax_tf
from anakin_tpu.runtime.decode_scheduler import DecodeScheduler as JaxScheduler
from anakin_tpu.runtime.decode_scheduler import sample_token as jax_sample_token
from anakin_tpu.runtime.generate import GenerationSession as JaxSession
from anakin_tpu_torch.models import transformer as pt_tf
from anakin_tpu_torch.quant import weight_only_quantize
from anakin_tpu_torch.runtime import DecodeScheduler
from anakin_tpu_torch.runtime.decode_scheduler import (device_sample,
                                                       hash_uniform,
                                                       sample_token)

BASE = dict(vocab=40, embed=64, heads=4, kv_heads=2, layers=2)


def _cfgs(**kw):
    c = dict(BASE, **kw)
    return jax_tf.TransformerConfig(**c), pt_tf.TransformerConfig(**c)


def _params(**kw):
    return pt_tf.make_transformer_params(pt_tf.TransformerConfig(
        **dict(BASE, **kw)), 5)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, BASE["vocab"], (p,)).astype(np.int32)
            for p in lengths]


def _serve(sched, reqs):
    """Submit every request, then let the scheduler admit; returns the
    results and the scheduler's counts (`k_done` of each window)."""
    go = threading.Event()
    admit, fused = sched._admit, sched._step_fused
    k_done = []

    def gated_admit():
        go.wait(timeout=60)
        admit()

    def counted_window():
        n = sched.steps_run
        fused()
        k_done.append(sched.steps_run - n)

    sched._admit, sched._step_fused = gated_admit, counted_window
    try:
        futs = [sched.submit(p, max_new_tokens=n, **kw) for p, n, kw in reqs]
        go.set()
        out = [f.result(timeout=300) for f in futs]
    finally:
        sched.close()  # the last step's bookkeeping ends before the join
    assert not sched._thread.is_alive()
    return out, dict(steps=sched.steps_run,
                     prefill_steps=sched.prefill_steps_run,
                     windows=sched.fused_windows_run,
                     bucket_prefills=sched.bucket_prefills_run,
                     buckets=sorted(sched._prefill_runs),
                     k_done=k_done, cache_bytes=sched.cache_bytes())


def _both(reqs, cfg_kw=None, **kw):
    """(JAX results, JAX counts), (port results, port counts)."""
    cfg_kw = cfg_kw or dict(max_seq=64)
    jc, pc = _cfgs(**cfg_kw)
    params = _params(**cfg_kw)
    want = _serve(JaxScheduler(jc, params=params, **kw), reqs)
    got = _serve(DecodeScheduler(pc, params=params, device="cpu", **kw), reqs)
    return want, got


def _assert_same(want, got):
    for w, g in zip(want[0], got[0]):
        np.testing.assert_array_equal(g, w)
    assert got[1] == want[1]


# mixed prompt lengths and budgets: slots finish inside windows and are
# refilled; buckets 32 and 64
_MIXED = [(3, 9), (5, 3), (2, 13), (4, 6), (6, 2), (30, 4), (40, 3)]


@pytest.mark.parametrize("fuse_window", [0, 2, 4, 16])
@pytest.mark.parametrize("prefill_mode", ["bucket", "chunked"])
def test_scheduler_matches_jax(prefill_mode, fuse_window):
    """Bucket and chunked (prefill_chunk 4) admission, the host per-step
    path and fused windows of 2, 4 and 16, b2."""
    reqs = [(p, n, {}) for p, (_, n) in zip(
        _prompts(0, [q for q, _ in _MIXED]), _MIXED)]
    want, got = _both(reqs, batch=2, prefill_mode=prefill_mode,
                      prefill_chunk=4, fuse_window=fuse_window)
    _assert_same(want, got)
    assert (got[1]["windows"] > 0) == (fuse_window > 1)


def test_scheduler_chunk_1_teacher_forces_like_jax():
    """prefill_chunk 1: the prompt goes through the per-step decode one
    token a step, P + N - 1 steps."""
    reqs = [(p, 4, {}) for p in _prompts(1, [7, 3])]
    want, got = _both(reqs, batch=2, prefill_mode="chunked", prefill_chunk=1)
    _assert_same(want, got)
    assert got[1]["steps"] == 7 + 4 - 1


def _greedy(prompt, n, max_seq=64):
    """The JAX session's greedy tokens after `prompt`."""
    jc, _ = _cfgs(max_seq=max_seq)
    s = JaxSession(jc, batch=1, params=_params(max_seq=max_seq))
    return [int(t) for t in s.generate(prompt[None], max_new_tokens=n)[0][
        len(prompt):]]


@pytest.mark.parametrize("fuse_window", [0, 16])
def test_scheduler_stop_tokens_match_jax(fuse_window):
    """A stop token inside a fused window and on the host path, and one
    that is the first token (from the admission): each result ends on its
    stop token; a request without one runs its whole budget."""
    P, N = 4, 12
    (prompt,) = _prompts(2, [P])
    gen = _greedy(prompt, N)
    stop_idx = next(i for i in range(3, N) if gen[i] not in gen[:i])
    unused = next(t for t in range(BASE["vocab"]) if t not in gen)
    reqs = [(prompt, N, dict(stop_tokens=(gen[stop_idx], unused))),
            (prompt, N, {}),
            (prompt, N, dict(stop_tokens=(gen[0],)))]
    want, got = _both(reqs, batch=2, fuse_window=fuse_window)
    _assert_same(want, got)
    assert list(got[0][0][P:]) == gen[:stop_idx + 1]
    assert list(got[0][2][P:]) == gen[:1]
    assert list(got[0][1][P:]) == gen


@pytest.mark.parametrize("weight_only,prefill_mode", [
    ("w8", "chunked"), ("w8", "bucket"), ("w4", "bucket"), ("w4", "chunked")])
def test_scheduler_weight_only_matches_jax(weight_only, prefill_mode):
    """weight_only w8 / w4 on every graph of the scheduler, int8 KV cache,
    fused windows of 4 (E 128, so the MLP weights are rewritten)."""
    reqs = [(p, n, {}) for p, n in zip(_prompts(3, [4, 9, 6]), (6, 3, 5))]
    want, got = _both(reqs, cfg_kw=dict(embed=128, max_seq=32), batch=2,
                      prefill_chunk=4, fuse_window=4, weight_only=weight_only,
                      kv_cache_dtype="int8", prefill_mode=prefill_mode)
    _assert_same(want, got)


def test_scheduler_weight_only_reuses_the_first_rewrite():
    """The scheduler packs the weights once; every later graph gets what
    `weight_only_quantize` would give it: the same nodes and the same
    weights (the very arrays of the first rewrite)."""
    _, pc = _cfgs(embed=128, max_seq=32)
    params = _params(embed=128, max_seq=32)
    sched = DecodeScheduler(pc, batch=2, params=params, weight_only="w4",
                            prefill_mode="chunked", prefill_chunk=4,
                            device="cpu")
    try:
        g = sched._maybe_weight_only(pt_tf.build_transformer_prefill(
            pc, 2, 32, params, last_token_only=True))
        want = weight_only_quantize(pt_tf.build_transformer_prefill(
            pc, 2, 32, params, last_token_only=True), bits=4)
        assert g.nodes.keys() == want.nodes.keys()
        for name, n in want.nodes.items():
            m = g.nodes[name]
            assert (m.op, m.inputs, m.outputs, m.attrs) == (
                n.op, n.inputs, n.outputs, n.attrs)
        assert g.params.keys() == want.params.keys()
        for k, v in want.params.items():
            np.testing.assert_array_equal(g.params[k], v)
            if k.endswith("__w4"):
                assert g.params[k] is sched.graph.params[k]
        assert sum(n.op == "dense_w4" for n in sched.vgraph.nodes.values()) == 4
    finally:
        sched.close()


@pytest.mark.parametrize("cache_view", ["auto", "off"])
@pytest.mark.parametrize("cache_update", ["blend", "rows"])
def test_scheduler_cache_views_match_jax(cache_view, cache_update):
    """Windows of 32 over a 320-row cache with views on (a generation that
    crosses the 128-row view into the 256 one) and off, with blend and
    per-row cache writes."""
    (prompt,) = _prompts(4, [20])
    reqs = [(prompt, 150, {}), (prompt[:7], 40, {})]
    want, got = _both(reqs, cfg_kw=dict(max_seq=320), batch=2, fuse_window=32,
                      cache_view=cache_view, cache_update=cache_update)
    _assert_same(want, got)


def test_scheduler_view_nets_match_jax():
    """The view buckets the windows take: 128 then 256 with views on,
    none with them off."""
    _, pc = _cfgs(max_seq=320)
    params = _params(max_seq=320)
    (prompt,) = _prompts(4, [20])
    views = {}
    for mode in ("auto", "off"):
        sched = DecodeScheduler(pc, batch=2, params=params, fuse_window=32,
                                cache_view=mode, device="cpu")
        try:
            sched.submit(prompt, max_new_tokens=150).result(timeout=300)
            views[mode] = sorted(sched._view_nets)
        finally:
            sched.close()
    assert views == {"auto": [128, 256], "off": []}


def test_scheduler_streams_in_order():
    """on_token gets every generated token, in order, before the future
    resolves with the same tokens, which equal the JAX scheduler's (the
    JAX run streams into the list first, then the port's)."""
    (prompt,) = _prompts(5, [4])
    streamed = []
    reqs = [(prompt, 7, dict(on_token=streamed.append))]
    want, got = _both(reqs, cfg_kw=dict(max_seq=32), batch=1, fuse_window=4)
    _assert_same(want, got)
    assert streamed == 2 * [int(t) for t in want[0][0][4:]]
    assert len(streamed) == 14


def _cancel_mid_generation(sched_cls, cfg, params, prompt):
    sched = sched_cls(cfg, batch=1, params=params, fuse_window=2,
                      **({} if sched_cls is JaxScheduler else
                         dict(device="cpu")))
    try:
        got_some, proceed = threading.Event(), threading.Event()

        def first_token(_):
            # hold the scheduler's thread until the cancel has landed
            got_some.set()
            proceed.wait(timeout=120)

        fut_a = sched.submit(prompt, max_new_tokens=40, on_token=first_token)
        assert got_some.wait(timeout=120)
        fut_a.cancel()
        proceed.set()
        got_b = sched.submit(prompt, max_new_tokens=5).result(timeout=300)
        assert fut_a.cancelled()
        # cancelled before admission: the request never takes a slot
        blocker = sched.submit(prompt, max_new_tokens=30)
        queued = sched.submit(prompt, max_new_tokens=5)
        queued.cancel()
        blocker.result(timeout=300)
        assert queued.cancelled()
        return got_b
    finally:
        sched.close()


def test_scheduler_cancellation_matches_jax():
    """A request cancelled mid-generation frees its slot; the next request
    in it decodes the same tokens as on the JAX scheduler."""
    jc, pc = _cfgs(max_seq=64)
    params = _params(max_seq=64)
    (prompt,) = _prompts(6, [4])
    want = _cancel_mid_generation(JaxScheduler, jc, params, prompt)
    got = _cancel_mid_generation(DecodeScheduler, pc, params, prompt)
    np.testing.assert_array_equal(got, want)


def _fails_then_serves(sched_cls, cfg, params, prompt):
    sched = sched_cls(cfg, batch=1, params=params, fuse_window=4,
                      **({} if sched_cls is JaxScheduler else
                         dict(device="cpu")))

    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    sched._fused_runs[(False, 0)] = boom    # greedy, full-cache view
    try:
        fut = sched.submit(prompt, max_new_tokens=6)
        with pytest.raises(RuntimeError, match="injected"):
            fut.result(timeout=300)
        sched._fused_runs.pop((False, 0), None)
        return sched.submit(prompt, max_new_tokens=6).result(timeout=300)
    finally:
        sched.close()


def test_scheduler_failure_recovery_matches_jax():
    """A window that fails fails its in-flight future; the arena is reset
    (the port zeroes its caches in place) and the next request decodes the
    JAX scheduler's tokens."""
    jc, pc = _cfgs(max_seq=32)
    params = _params(max_seq=32)
    (prompt,) = _prompts(7, [4])
    want = _fails_then_serves(JaxScheduler, jc, params, prompt)
    got = _fails_then_serves(DecodeScheduler, pc, params, prompt)
    np.testing.assert_array_equal(got, want)


def test_scheduler_failed_step_does_not_stop_serving():
    """A failing per-step decode (the host path) fails its future and the
    scheduler goes on serving; the caches are the same tensors after the
    reset (captured graphs keep their addresses)."""
    _, pc = _cfgs(max_seq=32)
    params = _params(max_seq=32)
    (prompt,) = _prompts(7, [4])
    sched = DecodeScheduler(pc, batch=1, params=params, device="cpu")
    caches = dict(sched._caches)

    def boom(feed):
        raise RuntimeError("injected step failure")

    sched._step_run = boom
    try:
        with pytest.raises(RuntimeError, match="injected"):
            sched.submit(prompt, max_new_tokens=3).result(timeout=300)
        assert all(sched._caches[k] is v and not v.any()
                   for k, v in caches.items())
        sched._step_run = None
        got = sched.submit(prompt, max_new_tokens=3).result(timeout=300)
    finally:
        sched.close()
    assert list(got[4:]) == _greedy(prompt, 3, max_seq=32)


# ------------------------------------------------------------- sampling

def test_sample_token_matches_jax():
    """The host sampler, bit for bit: the same logits and generator state
    give the same draws under every filter."""
    rng = np.random.default_rng(8)
    for temp, k, p in [(0.0, 0, 0.0), (0.8, 0, 0.0), (1.3, 5, 0.0),
                       (1.0, 0, 0.7), (0.7, 6, 0.9), (2.0, 40, 0.999)]:
        logits = rng.normal(size=40).astype(np.float32) * 3
        a, b = np.random.default_rng([3, 9]), np.random.default_rng([3, 9])
        got = [sample_token(logits, temp, k, p, a) for _ in range(50)]
        want = [jax_sample_token(logits, temp, k, p, b) for _ in range(50)]
        assert got == want


def _filtered(logits, temp, k, p):
    """The distribution `sample_token` draws from (float64)."""
    z = np.asarray(logits, np.float64) / temp
    if k:
        z = np.where(z < np.sort(z)[-k], -np.inf, z)
    q = np.exp(z - z.max())
    q /= q.sum()
    if 0 < p < 1:
        order = np.argsort(-q, kind="stable")
        keep = order[:int(np.searchsorted(np.cumsum(q[order]), p) + 1)]
        q = np.where(np.isin(np.arange(q.size), keep), q, 0.0)
        q /= q.sum()
    return q


@pytest.mark.parametrize("temp,k,p", [(1.0, 0, 0.0), (0.7, 4, 0.0),
                                      (1.5, 0, 0.8), (1.2, 6, 0.9)])
def test_device_sample_follows_the_filtered_distribution(temp, k, p):
    """20,000 draws (token index 0..19,999 of one request) over a
    10-token vocabulary: the counts pass a chi-square test against the
    filtered distribution at the 0.1% level (df = kept tokens - 1, the
    critical value from scipy), and no filtered-out token is drawn."""
    from scipy.stats import chi2

    n = 20000
    logits = torch.tensor([2.0, 1.5, 1.4, 1.0, 0.3, 0.0, -0.5, -1.0, -2.0,
                           -3.0])
    q = _filtered(logits.numpy(), temp, k, p)
    draws = device_sample(
        logits.expand(n, -1), 11, torch.full((n,), 3, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32), torch.full((n,), temp),
        torch.full((n,), k, dtype=torch.int32), torch.full((n,), p))
    counts = np.bincount(draws.numpy(), minlength=10)
    kept = q > 0
    assert counts[~kept].sum() == 0
    expect = n * q[kept]
    stat = float(((counts[kept] - expect) ** 2 / expect).sum())
    assert stat < chi2.ppf(0.999, int(kept.sum()) - 1), (stat, counts, expect)


def test_hash_uniform_is_a_function_of_its_keys():
    """Uniforms in (0, 1) that depend on (seed, rid, index) alone: a row is
    the same whatever else is in the batch, and each key moves it."""
    rid = torch.tensor([0, 7, 7, 3], dtype=torch.int32)
    idx = torch.tensor([5, 5, 6, 5], dtype=torch.int32)
    u = hash_uniform(1, rid, idx, 64)
    assert bool((u > 0).all() and (u < 1).all())
    torch.testing.assert_close(hash_uniform(1, rid[1:2], idx[1:2], 64), u[1:2],
                               rtol=0, atol=0)
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[1], u[2])
    assert not torch.equal(hash_uniform(2, rid, idx, 64), u)


def _sampled_run(pc, params, reqs, batch):
    out = _serve(DecodeScheduler(pc, batch=batch, params=params,
                                 fuse_window=4, seed=123, device="cpu"), reqs)
    assert out[1]["windows"] > 0, "sampling did not fuse"
    return out[0]


def test_device_sampling_top_k_1_is_greedy_and_batch_independent():
    """In fused windows: top_k = 1 at any temperature gives the greedy
    tokens; a sampled request (request id 0) draws the same tokens alone
    and in a full batch of other sampled requests."""
    _, pc = _cfgs(max_seq=32)
    params = _params(max_seq=32)
    prompts = _prompts(9, [4, 6, 3, 5])
    greedy = _sampled_run(pc, params, [(prompts[0], 8, {})], 1)[0]
    topk1 = _sampled_run(pc, params, [(prompts[0], 8, dict(
        temperature=0.9, top_k=1))], 1)[0]
    np.testing.assert_array_equal(topk1, greedy)
    kw = dict(temperature=1.5, top_k=5, top_p=0.9)
    alone = _sampled_run(pc, params, [(prompts[0], 8, kw)], 1)[0]
    full = _sampled_run(pc, params, [(prompts[0], 8, kw)] + [
        (p, n, dict(temperature=1.1)) for p, n in zip(prompts[1:], (3, 9, 5))],
        4)[0]
    np.testing.assert_array_equal(full, alone)
    assert ((alone >= 0) & (alone < BASE["vocab"])).all()


# -------------------------------------------------------------- devices

def test_scheduler_refuses_mesh_and_needs_cuda_by_default():
    _, pc = _cfgs(max_seq=32)
    # a mesh is a parallel.Mesh of ranks (tests/test_torch_parallel.py)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        DecodeScheduler(pc, batch=1, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DecodeScheduler(pc, batch=1, params=_params(max_seq=32))
