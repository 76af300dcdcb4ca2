"""The port's `SpeculativeSession` against the JAX package's
(`tests/test_speculative.py` on the port), on the CPU at a tiny float32
configuration: the same params, prompts and k on both sides.

Held exactly: the tokens of every loop (`generate` with and without
`adaptive_k`, `generate_round_fused`, `generate_fused`), float32 and int8 KV
caches, a draft equal to the target and a random one, against the JAX
session's tokens, against the port's own `GenerationSession` greedy, and
the counters (`rounds`, `tokens_committed`, `drafts_accepted`,
`drafts_proposed`) against the JAX session's.  The verify chunk of one
token against the decode step: rtol / atol 1e-4, as the JAX test holds
them (the two sum in other orders).
"""

import numpy as np
import pytest

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from anakin_tpu.models.transformer import TransformerConfig as JaxConfig
from anakin_tpu.models.transformer import make_transformer_params
from anakin_tpu.runtime.speculative import SpeculativeSession as JaxSession
from anakin_tpu_torch.models import (
    TransformerConfig,
    build_transformer_decode_step,
    build_transformer_verify_step,
)
from anakin_tpu_torch.runtime import GenerationSession, Net, SpeculativeSession

CFG = dict(vocab=97, embed=64, heads=4, kv_heads=2, layers=2, max_seq=64)
DRAFT = dict(vocab=97, embed=32, heads=2, kv_heads=2, layers=1, max_seq=64)
COUNTERS = ("rounds", "tokens_committed", "drafts_accepted",
            "drafts_proposed")
# (method, keyword arguments)
MODES = {
    "generate": ("generate", {}),
    "generate_adaptive_k": ("generate", dict(adaptive_k=True, k_min=1,
                                             k_max=4)),
    "round_fused": ("generate_round_fused", {}),
    "fused": ("generate_fused", {}),
}
# prompts (start, length) and new tokens, each run in turn on one session
RUNS = ((2, 8, 16), (5, 5, 11))


@pytest.fixture(scope="module")
def params():
    return make_transformer_params(JaxConfig(**CFG), 0)


def _sessions(params, kv, draft):
    """A JAX and a port session on the same weights: the draft is the
    target itself, or a smaller random model (seed 1, both sides)."""
    same = draft == "same"
    kw = dict(params=params, k=3, kv_cache_dtype=kv, kv_scale=0.05)
    if same:
        kw["draft_params"] = params
    js = JaxSession(JaxConfig(**CFG), JaxConfig(**(CFG if same else DRAFT)),
                    **kw)
    ps = SpeculativeSession(TransformerConfig(**CFG),
                            TransformerConfig(**(CFG if same else DRAFT)),
                            device="cpu", **kw)
    return js, ps


def _prompt(start, length):
    return (np.arange(start, start + length, dtype=np.int32) % CFG["vocab"])[None]


def test_verify_chunk1_matches_decode():
    """The verify graph with a chunk of 1 computes the decode step: logits
    and the written cache rows within 1e-4."""
    rng = np.random.default_rng(0)
    cfg = TransformerConfig(**CFG)
    params = make_transformer_params(JaxConfig(**CFG), 0)
    vg = build_transformer_verify_step(cfg, 1, 1, params)
    dg = build_transformer_decode_step(cfg, 1, params)
    shape = (1, cfg.kv_heads, cfg.max_seq, cfg.head_dim)
    caches = {f"cache_{kv}_{i}": rng.standard_normal(shape).astype(np.float32)
              for i in range(cfg.layers) for kv in "kv"}
    feed = dict(caches, input=np.array([[7]], np.int32),
                pos=np.array([5], np.int32))
    out_d = Net(dg, device="cpu").prediction(dict(feed))
    out_v = Net(vg, device="cpu").prediction(dict(feed))
    np.testing.assert_allclose(out_v[vg.outputs[0]].numpy(),
                               out_d[dg.outputs[0]].numpy(),
                               rtol=1e-4, atol=1e-4)
    for i in range(cfg.layers):
        nd, nv = dg.nodes[f"dec_att_{i}"], vg.nodes[f"ver_att_{i}"]
        for j in (1, 2):
            np.testing.assert_allclose(out_v[nv.outputs[j]].numpy(),
                                       out_d[nd.outputs[j]].numpy(),
                                       rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def shared(params):
    """One JAX and one port session per (kv cache, draft), and the port's
    greedy tokens per (kv cache, run), shared by the loops' cases (the JAX
    sessions compile once)."""
    sessions = {(kv, d): _sessions(params, kv, d)
                for kv in ("float32", "int8") for d in ("same", "random")}
    greedy = {}
    for kv in ("float32", "int8"):
        sess = GenerationSession(TransformerConfig(**CFG), batch=1,
                                 params=params, kv_cache_dtype=kv,
                                 kv_scale=0.05, device="cpu")
        for start, length, n in RUNS:
            greedy[kv, start] = sess.generate(_prompt(start, length), n)
    return sessions, greedy


@pytest.mark.parametrize("draft", ["same", "random"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_tokens_and_counters_match_jax_session(shared, mode, kv, draft):
    """Two prompts in turn: the tokens equal the JAX session's and the
    port's greedy `GenerationSession`'s, and what every counter gained in
    each run equals the JAX session's gain."""
    method, kw = MODES[mode]
    sessions, greedy = shared
    js, ps = sessions[kv, draft]
    gained = {c: 0 for c in COUNTERS}
    for start, length, n in RUNS:
        prompt = _prompt(start, length)
        before = {c: (getattr(js, c), getattr(ps, c)) for c in COUNTERS}
        want = getattr(js, method)(prompt, n, **kw)
        got = getattr(ps, method)(prompt, n, **kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, greedy[kv, start])
        for c, (j0, p0) in before.items():
            assert getattr(ps, c) - p0 == getattr(js, c) - j0, c
            gained[c] += getattr(ps, c) - p0
    assert gained["tokens_committed"] >= gained["rounds"]
    if draft == "same":  # as the JAX test: near-tie argmax flips only
        assert gained["drafts_accepted"] >= 0.5 * gained["drafts_proposed"]
        assert gained["tokens_committed"] / gained["rounds"] > 1.5


def test_captured_steps_serve_every_prompt_length(params):
    """One round step and one window step serve every prompt length, N and
    position; windows shorter than the generation take several replays;
    both loops give the host loop's tokens in as many rounds."""
    _, ps = _sessions(params, "float32", "random")
    ps.WINDOW_ROUNDS = 2
    for start, length, n in RUNS + ((1, 30, 17),):
        prompt = _prompt(start, length)
        want = ps.generate(prompt, n)
        rounds = []
        for method in ("generate_round_fused", "generate_fused"):
            r0 = ps.rounds
            np.testing.assert_array_equal(getattr(ps, method)(prompt, n), want)
            rounds.append(ps.rounds - r0)
        assert rounds[0] == rounds[1] > 2
    assert list(ps._round_runs) == [3] and list(ps._window_runs) == [(3, 2)]


class _NoHostSync(TorchDispatchMode):
    """Raises where an op reads a tensor's value on the host (`.item()`,
    indexing by a 0-dim tensor, `bool(t)`): on CUDA such an op inside a
    captured step fails the capture."""

    SYNCS = (torch.ops.aten.item.default,
             torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.is_nonzero.default)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.SYNCS:
            raise AssertionError(f"a host sync ({func}) inside a captured "
                                 f"step")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("method", ["generate_round_fused", "generate_fused"])
def test_captured_steps_make_no_host_sync(params, shared, method,
                                          monkeypatch):
    """The round and the window, run here eagerly, read no tensor value on
    the host (the check a CUDA capture makes), and the host reads each
    step's output once, after it."""
    from anakin_tpu_torch.runtime import speculative

    real = speculative.compile_step

    def checked(fn, inputs, static, device):
        def no_sync(x):
            with _NoHostSync():
                return fn(x)
        return real(no_sync, inputs, static, device)

    monkeypatch.setattr(speculative, "compile_step", checked)
    _, ps = _sessions(params, "int8", "random")
    start, length, n = RUNS[0]
    np.testing.assert_array_equal(
        getattr(ps, method)(_prompt(start, length), n),
        shared[1]["int8", start])


def test_full_round_leaves_the_drafts_last_row_unwritten_as_in_jax(shared):
    """Draft = target: one round (k + 2 tokens) accepts every draft on each
    loop.  After a fully accepted round the draft never saw its last draft
    token, so its cache lacks that row and later rounds accept less, in
    the JAX package as in the port (copied, so that the counters are the
    JAX session's); the tokens stay greedy's."""
    js, ps = shared[0]["float32", "same"]
    prompt = _prompt(6, 9)
    for n in (3 + 2, 40):
        for method in ("generate", "generate_round_fused", "generate_fused"):
            before = {c: (getattr(js, c), getattr(ps, c)) for c in COUNTERS}
            np.testing.assert_array_equal(getattr(ps, method)(prompt, n),
                                          getattr(js, method)(prompt, n))
            gain = {c: getattr(ps, c) - p0 for c, (_, p0) in before.items()}
            assert gain == {c: getattr(js, c) - j0
                            for c, (j0, _) in before.items()}
            rate = gain["drafts_accepted"] / gain["drafts_proposed"]
            if n == 5:
                assert gain["rounds"] == 1 and rate == 1.0
            else:
                assert rate < 1.0


def test_one_new_token_runs_no_round(params):
    """N = 1 is the prefill's token alone: no round on any path."""
    _, ps = _sessions(params, "float32", "random")
    prompt = _prompt(3, 6)
    outs = [getattr(ps, m)(prompt, 1) for m in
            ("generate", "generate_round_fused", "generate_fused")]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    assert outs[0].shape == (1, 7) and ps.rounds == 0


def test_bf16_paths_agree():
    """In bf16 the three loops give the same tokens (each verify chunk and
    draft step is the same arithmetic on every path)."""
    cfg = TransformerConfig(**CFG)
    params = make_transformer_params(JaxConfig(**CFG), 0)
    ps = SpeculativeSession(cfg, TransformerConfig(**DRAFT), params=params,
                            k=4, precision="bf16", kv_cache_dtype="int8",
                            device="cpu")
    prompt = _prompt(4, 9)
    outs = [getattr(ps, m)(prompt, 20) for m in
            ("generate", "generate_round_fused", "generate_fused")]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


def test_session_checks_its_arguments(params):
    _, ps = _sessions(params, "float32", "random")
    with pytest.raises(ValueError, match="batch"):
        ps.generate(np.zeros((2, 4), np.int32), 4)
    with pytest.raises(ValueError, match="max_seq"):
        ps.generate_fused(np.zeros((1, 50), np.int32), 12)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a GPU is present; the default device is usable")
def test_session_defaults_to_cuda():
    with pytest.raises(RuntimeError, match="CUDA"):
        SpeculativeSession(TransformerConfig(**CFG), TransformerConfig(**DRAFT))
