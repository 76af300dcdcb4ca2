"""The port's autotuner against the JAX package's (`tests/test_autotune.py`
on the port), on the CPU, where the baseline is the only candidate and
nothing is timed: the tuned graphs equal the JAX tuner's, the decisions
persist in the versioned cache, and a second run reuses them.  Also the
device name in the key, the drop of a cache of another schema, the margin
(with the timer stubbed, since timing needs a card), `optimize(autotune=
True)`, and int8 / w4 `impl` left as it was.
"""

import json

import numpy as np
import pytest

import torch

import anakin_tpu as ak
from anakin_tpu.graph.ir import GraphBuilder as JaxGraphBuilder
from anakin_tpu.kernels.autotune import AutoTuner as JaxAutoTuner
from anakin_tpu.kernels.autotune import autotune_graph as jax_autotune_graph
import anakin_tpu_torch as pt
from anakin_tpu_torch.graph.ir import GraphBuilder
from anakin_tpu_torch.kernels import autotune
from anakin_tpu_torch.kernels.autotune import AutoTuner, autotune_graph


def _attn_graph(builder=GraphBuilder, S=512, E=16, H=2):
    rng = np.random.default_rng(0)
    b = builder("attn")
    x = b.input((1, S, E), "float32", name="x")
    y = b.op("multi_head_attention", [
        x,
        b.param(rng.normal(size=(E, E)).astype(np.float32) * 0.1, "wq"),
        b.param(rng.normal(size=(E, E)).astype(np.float32) * 0.1, "wk"),
        b.param(rng.normal(size=(E, E)).astype(np.float32) * 0.1, "wv"),
        b.param(rng.normal(size=(E, E)).astype(np.float32) * 0.1, "wo"),
    ], num_heads=H, causal=True, rope=False)
    b.output(y)
    return b.graph


def _attention_node(g):
    (node,) = [n for n in g.nodes.values() if n.op == "multi_head_attention"]
    return node


def test_attention_autotune_cpu_picks_dense(tmp_path):
    """On the CPU the dense baseline is chosen untimed; the tuned graph
    equals the JAX tuner's, runs and matches the untuned one and the JAX
    net; the decision persists and a second tuner reuses it without
    timing (its candidates are not callable)."""
    g = _attn_graph()
    cache = tmp_path / "tune.json"
    tuner = AutoTuner(str(cache), device="cpu")
    gt = autotune_graph(g, tuner)
    assert _attention_node(gt).attrs["impl"] == "dense"
    assert "autotune" in gt.applied_passes
    assert "impl" not in _attention_node(g).attrs   # the input is not changed
    assert tuner.timings == {}                      # nothing was timed
    jt = jax_autotune_graph(_attn_graph(JaxGraphBuilder),
                            JaxAutoTuner(str(tmp_path / "jax.json")))
    assert {n: (x.op, x.inputs, x.outputs, x.attrs)
            for n, x in gt.nodes.items()} == {
        n: (x.op, x.inputs, x.outputs, x.attrs) for n, x in jt.nodes.items()}
    assert gt.applied_passes == jt.applied_passes

    x = np.random.default_rng(1).normal(size=(1, 512, 16)).astype(np.float32)
    y0 = pt.Net(g, device="cpu").prediction({"x": x})[g.outputs[0]]
    y1 = pt.Net(gt, device="cpu").prediction({"x": x})[gt.outputs[0]]
    yj = np.asarray(ak.Net(jt).prediction({"x": x})[jt.outputs[0]])
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y1.numpy(), yj, rtol=1e-5, atol=1e-5)

    raw = json.loads(cache.read_text())
    assert raw["__schema__"] == autotune._CACHE_SCHEMA
    assert list(raw["entries"].values()) == ["dense"]
    tuner2 = AutoTuner(str(cache), device="cpu")
    key = next(iter(raw["entries"]))
    assert tuner2.pick(key, {"dense": None, "flash": None},
                       baseline="dense") == "dense"


def test_attention_autotune_skips_short_seq(tmp_path):
    gt = autotune_graph(_attn_graph(S=128),
                        AutoTuner(str(tmp_path / "t.json"), device="cpu"))
    assert "impl" not in _attention_node(gt).attrs  # below S = 512: untouched
    assert not (tmp_path / "t.json").exists()


@pytest.mark.parametrize("op,impl", [("dense_int8", None),
                                     ("dense_int8", "pallas"),
                                     ("dense_w4", None),
                                     ("dense_w4", "pallas")])
def test_int8_and_w4_impl_left_as_it_was(tmp_path, op, impl):
    """The JAX tuner times its int8 and w4 nodes (XLA against Pallas; on
    the CPU it writes "xla"); the port runs them on its kernels whatever
    `impl` says, so its tuner leaves `impl` as it was: absent, or "pallas"
    with `variant="v2"` (which `dense_w4` reads), and times nothing."""
    rng = np.random.default_rng(0)
    b = GraphBuilder("q")
    x = b.input((4, 32), "float32" if op == "dense_w4" else "int8", name="x")
    attrs = {} if impl is None else dict(impl=impl, variant="v2")
    if op == "dense_int8":
        w = b.param(rng.integers(-127, 128, size=(32, 16)).astype(np.int8))
        ws = b.param(np.full((16,), 0.01, np.float32))
        y = b.op(op, [x, w, ws], in_scale=0.05, out_scale=0.1, **attrs)
    else:
        w = b.param(rng.integers(-127, 128, size=(16, 16)).astype(np.int8))
        ws = b.param(np.full((1, 16), 0.01, np.float32))
        y = b.op(op, [x, w, ws], w4_group=32, **attrs)
    b.output(y)
    tuner = AutoTuner(str(tmp_path / "t.json"), device="cpu")
    gt = autotune_graph(b.graph, tuner)
    (node,) = gt.nodes.values()
    assert node.attrs.get("impl") == impl
    assert node.attrs.get("variant") == (None if impl is None else "v2")
    assert "autotune" in gt.applied_passes and tuner.cache == {}


def test_optimize_autotune_integration(tmp_path):
    """optimize(g, autotune=True) runs the tuner last and persists its
    decisions; `tuner_device` picks the timing device."""
    g = _attn_graph()
    gt = pt.optimize(g, autotune=True, tuner_cache=str(tmp_path / "c.json"),
                     tuner_device="cpu")
    assert _attention_node(gt).attrs["impl"] == "dense"
    assert (tmp_path / "c.json").exists()
    assert "autotune" in gt.applied_passes


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a GPU is present; the default device is usable")
def test_tuner_defaults_to_cuda():
    """Without a GPU the tuner's default device raises, as `Net`'s does."""
    with pytest.raises(RuntimeError, match="CUDA"):
        AutoTuner()
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.optimize(_attn_graph(), autotune=True)


def test_cache_key_names_the_device(monkeypatch):
    """The key holds the JAX key's fields with the device's name in place
    of `jax.default_backend()`: the card's name on CUDA, "cpu" here."""
    from anakin_tpu.graph.shape_infer import infer_shapes as jax_infer
    from anakin_tpu.kernels.autotune import _node_key as jax_node_key
    from anakin_tpu_torch.graph.shape_infer import infer_shapes

    g = _attn_graph()
    jg = _attn_graph(JaxGraphBuilder)
    key = json.loads(autotune._node_key(_attention_node(g), infer_shapes(g),
                                        torch.device("cpu")))
    want = json.loads(jax_node_key(_attention_node(jg), jax_infer(jg)))
    assert want.pop("backend") == "cpu" and key.pop("device") == "cpu"
    assert key == want
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert autotune.device_name(torch.device("cuda", 0)) == \
        "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("schema", [None, 3, 4])
def test_cache_of_another_schema_is_dropped(tmp_path, schema):
    """A cache of another schema (the JAX package writes 3; a file with
    none) loads empty, so a later run tunes anew; the port's own loads."""
    path = tmp_path / "c.json"
    entries = {"k": "flash"}
    raw = entries if schema is None else {"__schema__": schema,
                                          "entries": entries}
    path.write_text(json.dumps(raw))
    tuner = AutoTuner(str(path), device="cpu")
    assert tuner.cache == (entries if schema == autotune._CACHE_SCHEMA
                           else {})


def test_jax_written_cache_is_dropped(tmp_path):
    """The JAX tuner's own file for the same graph is not read."""
    path = str(tmp_path / "jax.json")
    jax_autotune_graph(_attn_graph(JaxGraphBuilder), JaxAutoTuner(path))
    assert json.loads(open(path).read())["entries"]
    assert AutoTuner(path, device="cpu").cache == {}


@pytest.mark.parametrize("times,want", [
    ({"dense": 1.2, "flash": 1.0}, "dense"),     # inside the 1.3 margin
    ({"dense": 1.3, "flash": 1.0}, "dense"),     # at it
    ({"dense": 1.31, "flash": 1.0}, "flash"),    # beyond it
    ({"dense": 0.9, "flash": 1.0}, "dense"),
    ({"flash": 1.0}, RuntimeError),              # the baseline failed
])
def test_pick_keeps_the_baseline_within_the_margin(tmp_path, monkeypatch,
                                                   times, want):
    """`pick` with the timer stubbed (timing needs a card): a candidate
    must beat the baseline by 1.3x; the times are kept in `timings` and
    the winner in the cache.  A candidate that raises makes `pick` raise
    and caches nothing, so a broken kernel never passes as the plain
    path's win."""
    tuner = AutoTuner(str(tmp_path / "c.json"), device="cpu")

    def fake_time(thunk):
        return thunk()

    def fail():
        raise RuntimeError("no kernel")

    monkeypatch.setattr(tuner, "_time_ms", fake_time)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    cands = {name: (lambda t=times.get(name): t) if name in times else fail
             for name in ("dense", "flash")}
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="no kernel"):
            tuner.pick("k", cands, baseline="dense")
        assert tuner.cache == {} and tuner.timings == {}
        assert not (tmp_path / "c.json").exists()
        return
    assert tuner.pick("k", cands, baseline="dense") == want
    assert tuner.timings["k"] == times
    assert AutoTuner(str(tmp_path / "c.json"), device="cpu").cache == {
        "k": want}


@pytest.mark.parametrize("failing", ["dense", "flash", "both"])
def test_pick_raises_when_every_candidate_fails(tmp_path, monkeypatch,
                                                failing):
    """Any failing candidate raises its own error, whichever it is, and no
    choice reaches the cache file."""
    path = tmp_path / "c.json"
    tuner = AutoTuner(str(path), device="cpu")

    def fail():
        raise RuntimeError("no kernel")

    monkeypatch.setattr(tuner, "_time_ms", lambda thunk: thunk())
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    cands = {name: fail if failing in (name, "both") else (lambda: 1.0)
             for name in ("dense", "flash")}
    with pytest.raises(RuntimeError, match="no kernel"):
        tuner.pick("k", cands, baseline="dense")
    assert tuner.cache == {} and not path.exists()


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.mark.parametrize("E,H,timed", [
    (96, 2, False),    # D 48: no dtype's kernel takes it
    (512, 2, False),   # D 256: the bf16 kernel takes it, the float32 not
    (256, 2, True),    # D 128: both candidates
])
def test_tuner_offers_flash_only_at_a_head_dim_the_kernel_takes(
        tmp_path, monkeypatch, E, H, timed):
    """A tuner that looks like CUDA (timer stubbed, operands made on the
    CPU): at a head dim the float32 flash kernel refuses, dense is kept and
    nothing is timed, so `optimize(autotune=True)` does not raise on the
    card for such a graph; at D 128 both candidates are still timed."""
    tuner = AutoTuner(str(tmp_path / "c.json"), device="cpu")
    tuner.device = torch.device("cuda", 0)
    timed_calls = []

    def fake_time(thunk):
        timed_calls.append(thunk)
        return 1.0

    real_operands = autotune._operands
    monkeypatch.setattr(tuner, "_time_ms", fake_time)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(autotune, "_operands", lambda g, n, s, r, d:
                        real_operands(g, n, s, r, torch.device("cpu")))
    gt = autotune_graph(_attn_graph(E=E, H=H), tuner)
    assert _attention_node(gt).attrs["impl"] == "dense"
    if timed:
        assert len(timed_calls) == 2
        assert [sorted(t) for t in tuner.timings.values()] == [
            ["dense", "flash"]]
    else:
        assert timed_calls == [] and tuner.timings == {}
        assert list(tuner.cache.values()) == ["dense"]
