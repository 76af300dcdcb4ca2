"""The port's parallelism (`anakin_tpu_torch/parallel/`, `Net(mesh=...)`,
`DecodeScheduler(mesh=...)`) against the JAX package's, on the CPU, at the
JAX tests' sizes (`tests/test_parallel.py`, `test_overlap.py`,
`test_distributed.py`).

The JAX side runs on the 8 virtual CPU devices of `tests/conftest.py`.
The port side runs SPMD: `tests/torch_parallel_worker.py` is started as
gloo ranks (one suite of 4 ranks, one of 2, both started once for the
module), each rank pickles what it computed, and the tests here read it.
Rules, `split_graph`, `PipelinedNet` (on `["cpu"] * 4`) and the meshes'
shapes need no group and run in this process.

Tolerances, and why:
  * sharding rules, meshes' shapes, `split_graph`'s stages: equal;
  * a TP float ResNet-50 against JAX's sharded and unsharded nets: rtol
    1e-4, atol 1e-5 (`tests/test_parallel.py`); every rank's output equal
    to every other's;
  * a TP int8 ResNet-50: every int8 edge equal to the port's unsharded
    net's (the kernels' epilogues are per column), as the JAX sharded
    net's equal the JAX unsharded net's; the softmax against the JAX nets
    within the JAX suite's rtol 1e-4 / atol 1e-5;
  * the TP decode step (float, w8, w4 with the embedding), at each overlap
    level: rtol / atol 2e-4 (`test_tp_sharded_decode`), as the row pairs
    sum their partial products in another order;
  * scheduler tokens: equal;
  * ring attention: the JAX `ring_attention`'s rows within 1e-5; the
    overlap rings against the dense product within the JAX tests' 1e-5
    (allgather, int8) and 1e-4 (reducescatter);
  * the wire bytes of `collective_stats`: equal to the JAX parser's on HLO
    lines written from the same records.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import anakin_tpu as ak
from anakin_tpu.models import build_resnet50 as jax_build_resnet50
from anakin_tpu.models import transformer as jax_tf
from anakin_tpu.parallel import make_hybrid_mesh as jax_make_hybrid_mesh
from anakin_tpu.parallel import make_mesh as jax_make_mesh
from anakin_tpu.parallel import shard_graph_params as jax_rules
from anakin_tpu.parallel import split_graph as jax_split_graph
from anakin_tpu.parallel.overlap import allgather_matmul as jax_allgather_matmul
from anakin_tpu.parallel.overlap import \
    matmul_reducescatter as jax_matmul_reducescatter
from anakin_tpu.parallel.ring_attention import ring_attention as jax_ring
from anakin_tpu.parallel.scaling import collective_stats as jax_stats
from anakin_tpu.quant import calibrate as jax_calibrate
from anakin_tpu.quant import quantize_graph as jax_quantize_graph
from anakin_tpu.quant import weight_only_quantize as jax_wo
from anakin_tpu.runtime.decode_scheduler import DecodeScheduler as JaxScheduler
import anakin_tpu_torch as pt
from anakin_tpu_torch.models import build_resnet50
from anakin_tpu_torch.models import transformer as pt_tf
from anakin_tpu_torch.parallel import (PipelinedNet, batch_axes,
                                       batch_size_of, make_hybrid_mesh,
                                       make_mesh, shard_graph_params,
                                       split_graph)
from anakin_tpu_torch.parallel import overlap
from anakin_tpu_torch.quant import weight_only_quantize, write_scale_table

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_worker as worker  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
F32_TOL = dict(rtol=1e-4, atol=1e-5)
DECODE_TOL = dict(rtol=2e-4, atol=2e-4)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(suite, world, d):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    return [subprocess.Popen(
        [sys.executable, WORKER, str(port), str(r), str(world), suite, d],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT) for r in range(world)]


def _finish(procs, suite, d):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK rank={r}" in out, \
            f"{suite} rank {r}:\n{out[-3000:]}"
    res = []
    for r in range(len(procs)):
        with open(os.path.join(d, f"{suite}_{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


@pytest.fixture(scope="module")
def resnet_case(tmp_path_factory):
    """The JAX ResNet-50 (b8, 32 px), its input, its max-calibrated int8
    graph; the scale table and input written for the workers."""
    d = str(tmp_path_factory.mktemp("parallel"))
    g = ak.optimize(jax_build_resnet50(batch=8, image_size=32))
    x = np.random.default_rng(1234).normal(size=(8, 32, 32, 3)).astype(
        np.float32)
    scales = jax_calibrate(g, [{"input": x}], method="max")
    np.save(os.path.join(d, "resnet_x.npy"), x)
    write_scale_table(scales, os.path.join(d, "scales.txt"))
    return d, g, x, jax_quantize_graph(g, scales)


@pytest.fixture(scope="module")
def ranks(resnet_case):
    """Both worker suites, started together: {suite: [rank results]}."""
    d = resnet_case[0]
    four, two = _start("four", 4, d), _start("two", 2, d)
    return {"two": _finish(two, "two", d), "four": _finish(four, "four", d)}


# ------------------------------------------------------------- the meshes

def test_mesh_shapes_and_errors_equal_jax():
    """Shapes, batch axes and the four ValueErrors, on 8 ranks (no group
    needed) against 8 devices."""
    for kw in ({"model": 2}, {"model": 4}, {"data": 2, "model": 4}):
        assert make_mesh(range(8), **kw).shape == dict(jax_make_mesh(**kw).shape)
    for kw in ({"dcn": 2, "model": 2}, {"dcn": 4}, {"dcn": 2, "data": 2,
                                                    "model": 2}):
        m, jm = make_hybrid_mesh(devices=range(8), **kw), jax_make_hybrid_mesh(**kw)
        assert m.shape == dict(jm.shape)
        assert batch_axes(m) == ("dcn", "data") and batch_size_of(m) == \
            m.shape["dcn"] * m.shape["data"]
    flat = make_mesh(range(8), model=2)
    assert batch_axes(flat) == ("data",) and batch_size_of(flat) == 4
    bad = [(make_mesh, dict(model=3)), (make_mesh, dict(data=3, model=2)),
           (make_hybrid_mesh, dict(dcn=3)),
           (make_hybrid_mesh, dict(dcn=2, data=3, model=1))]
    jax_fns = {make_mesh: jax_make_mesh, make_hybrid_mesh: jax_make_hybrid_mesh}
    for fn, kw in bad:
        with pytest.raises(ValueError) as e:
            fn(devices=list(range(8)), **kw)
        with pytest.raises(ValueError) as je:
            jax_fns[fn](**kw)
        assert str(e.value) == str(je.value)


def test_worker_meshes_and_the_two_process_group(ranks):
    """`initialize` joined the ranks (an all-reduce over 4 processes gives
    1+2+3+4 on each); the meshes the ranks built have the JAX shapes."""
    for r in ranks["four"]:
        assert r["init"] == (True, 0, 10.0)
        assert r["mesh_shapes"] == {
            "tp1": {"data": 4, "model": 1}, "tp2": {"data": 2, "model": 2},
            "tp4": {"data": 1, "model": 4},
            "hybrid": {"dcn": 2, "data": 1, "model": 2}}


# -------------------------------------------------------------- the rules

def _decode_graphs(pkg, tf_mod, wo, **cfg_kw):
    cfg = tf_mod.TransformerConfig(**cfg_kw)
    g = tf_mod.build_transformer_decode_step(
        cfg, 4, tf_mod.make_transformer_params(cfg, 4))
    return {"float": g, "w8": wo(g, min_elems=1024),
            "w4": wo(g, bits=4, min_elems=1024)}


def _rule_cases():
    both = {"resnet50": (pt.optimize(build_resnet50(batch=8, image_size=32)),
                         ak.optimize(jax_build_resnet50(batch=8,
                                                        image_size=32)))}
    pg = _decode_graphs("pt", pt_tf, weight_only_quantize, **worker.DECODE)
    jg = _decode_graphs("jax", jax_tf, jax_wo, **worker.DECODE)
    for k in pg:
        both[f"decode_{k}"] = (pg[k], jg[k])
    for name, kw in (("swiglu", worker.SWIGLU),):
        both[name] = (pt_tf.build_transformer_decode_step(
            pt_tf.TransformerConfig(**kw), 2,
            pt_tf.make_transformer_params(pt_tf.TransformerConfig(**kw), 5)),
            jax_tf.build_transformer_decode_step(
            jax_tf.TransformerConfig(**kw), 2,
            jax_tf.make_transformer_params(jax_tf.TransformerConfig(**kw), 5)))
    return both


@pytest.fixture(scope="module")
def rule_cases():
    return _rule_cases()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["resnet50", "decode_float", "decode_w8",
                                  "decode_w4", "swiglu"])
def test_rules_equal_jax_spec_for_spec(rule_cases, name, tp):
    g, jg = rule_cases[name]
    for mc in (128, 64):
        got = shard_graph_params(g, make_mesh(range(8), model=tp),
                                 min_channels=mc)
        want = jax_rules(jg, jax_make_mesh(model=tp), min_channels=mc)
        assert set(got) == set(want) == set(g.params)
        for e in want:
            assert got[e] == tuple(want[e].spec), (e, got[e], want[e].spec)
    sharded = sum(1 for s in got.values() if s != ())
    assert sharded > (20 if name == "resnet50" else 4)


# ------------------------------------------------------------ TP ResNet-50

@pytest.fixture(scope="module")
def jax_resnet(resnet_case):
    """The JAX nets' outputs: float and int8, unsharded and on a (2, 2)
    mesh of 4 devices; the int8 nets with every int8 edge tapped."""
    d, g, x, gq = resnet_case
    mesh = jax_make_mesh(jax.devices()[:4], model=2)
    edges = [n.outputs[0] for n in ak.topological_order(gq)
             if n.op in ("conv2d_int8", "dense_int8", "pool2d_int8")]
    out = {"f": np.asarray(ak.Net(g).prediction({"input": x})[g.outputs[0]]),
           "f_tp2": np.asarray(ak.Net(
               g, param_sharding=jax_rules(g, mesh), mesh=mesh).prediction(
               {"input": x})[g.outputs[0]])}
    for key, kw in (("q", {}), ("q_tp2", dict(param_sharding=jax_rules(gq, mesh),
                                              mesh=mesh))):
        taps = ak.Net(gq, tap_edges=edges, **kw).prediction({"input": x})
        out[key] = {k: np.asarray(v) for k, v in taps.items()}
    return out


@pytest.mark.parametrize("mesh", ["tp1", "tp2", "tp4", "hybrid"])
def test_tp_resnet_float_equals_jax(ranks, jax_resnet, mesh):
    """dp x tp (and dcn x tp) ResNet-50 on 4 ranks: each rank's whole
    output equals the other ranks', the JAX unsharded net's and the JAX
    (2, 2)-sharded net's."""
    outs = [r["resnet_f"][mesh] for r in ranks["four"]]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    np.testing.assert_allclose(outs[0], jax_resnet["f"], **F32_TOL)
    np.testing.assert_allclose(outs[0], jax_resnet["f_tp2"], **F32_TOL)


@pytest.mark.parametrize("mesh", ["tp2", "tp4"])
def test_tp_resnet_int8_edges_equal(ranks, jax_resnet, mesh):
    """Every int8 edge of the TP int8 net equals the port's unsharded
    net's on every rank, as the JAX sharded net's equal the JAX unsharded
    net's: sharding adds no difference on either side.  (The port's and
    the JAX package's unsharded nets part by an LSB at the strided convs,
    which `tests/test_torch_resnet.py` holds node by node.)"""
    r0 = ranks["four"][0]
    edges = r0["int8_edges"]
    for r in ranks["four"]:
        got = r["resnet_q"][mesh]
        for e in edges:
            np.testing.assert_array_equal(got[e], r0["resnet_q_unsharded"][e],
                                          err_msg=e)
    got = r0["resnet_q"][mesh]
    for e in edges:
        assert got[e].dtype == jax_resnet["q"][e].dtype
        np.testing.assert_array_equal(jax_resnet["q_tp2"][e],
                                      jax_resnet["q"][e], err_msg=e)


def test_tp_resnet_int8_softmax_equals_jax(ranks, jax_resnet, resnet_case):
    g = resnet_case[3]
    for mesh in ("tp2", "tp4"):
        for key in ("q", "q_tp2"):
            np.testing.assert_allclose(
                ranks["four"][0]["resnet_q"][mesh][g.outputs[0]],
                jax_resnet[key][g.outputs[0]], **F32_TOL)


# ------------------------------------------------------ TP decode step

@pytest.fixture(scope="module")
def jax_decode():
    """The JAX decode step's logits (float, w8, w4), unsharded and on a
    (4, 2) mesh, on the worker's feed."""
    cfg = jax_tf.TransformerConfig(**worker.DECODE)
    graphs = _decode_graphs("jax", jax_tf, jax_wo, **worker.DECODE)
    feed = worker._decode_feed(cfg, 4, 5)
    mesh = jax_make_mesh(model=2)
    out = {}
    for k, g in graphs.items():
        out[k] = np.asarray(ak.Net(g).prediction(feed)[g.outputs[0]])
        out[k, "tp2"] = np.asarray(ak.Net(
            g, param_sharding=jax_rules(g, mesh), mesh=mesh).prediction(
            feed)[g.outputs[0]])
    return out


@pytest.mark.parametrize("level", [None, "default", "aggressive"])
@pytest.mark.parametrize("kind", ["float", "w8", "w4"])
def test_tp_decode_step_equals_jax(ranks, jax_decode, kind, level):
    """The TP decode step on 2 ranks (Megatron attention, E-sharded
    embedding, row pairs, w4 column shards and row pairs) against the JAX
    step, sharded and not, under each overlap level."""
    for r in ranks["two"]:
        got = r["decode"][kind, level]
        np.testing.assert_allclose(got, jax_decode[kind], **DECODE_TOL)
        np.testing.assert_allclose(got, jax_decode[kind, "tp2"], **DECODE_TOL)
        np.testing.assert_allclose(got, r["decode_unsharded", kind],
                                   **DECODE_TOL)


def test_tp_decode_runs_each_rule_and_ring(ranks):
    """The nodes run as the rules say: attention on its heads, the
    embedding and up-projections on column blocks, the down-projections as
    row pairs; "aggressive" sends the float row pairs through the rings
    (collective-permutes), the other levels all-reduce."""
    r = ranks["two"][0]
    for kind in ("float", "w8", "w4"):
        kinds = r["decode_kinds", kind]
        assert [kinds[n] for n in kinds if n.startswith("dec_att_")] == \
            ["attn", "attn"], kinds
        assert sum(v == "row" for v in kinds.values()) == 2
        assert sum(v == "col" for v in kinds.values()) == 3
        assert "all-reduce" in r["decode_colls", kind, None]
    assert "collective-permute" in r["decode_colls", "float", "aggressive"]
    assert "collective-permute" not in r["decode_colls", "float", "default"]


def test_tp_decode_caches_are_written_on_their_heads(ranks):
    """The head-sharded caches come back whole and equal to the unsharded
    step's (each rank wrote the new row on its heads)."""
    for kind in ("float", "w8", "w4"):
        a, b = (r["decode_caches", kind] for r in ranks["two"])
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- TP scheduler

def _jax_tokens(cfg_kw, reqs, **kw):
    cfg = jax_tf.TransformerConfig(**cfg_kw)
    sched = JaxScheduler(cfg, batch=2, params=jax_tf.make_transformer_params(
        cfg, 5), fuse_window=4, **kw)
    try:
        return [sched.submit(p, max_new_tokens=n).result(timeout=300)
                for p, n in reqs]
    finally:
        sched.close()


def test_tp_scheduler_tokens_equal_jax(ranks):
    """`test_tp_sharded_decode_scheduler`'s config over a 2-rank mesh:
    bucket admissions and fused windows ran, the ranks never disagreed on
    a token, and the tokens equal the unsharded port scheduler's and the
    JAX scheduler's."""
    r = ranks["two"][0]
    tp, base = r["sched_tp"], r["sched_base"]
    assert tp["windows"] > 0 and tp["bucket_prefills"] > 0
    assert tp["disagreements"] == 0
    want = _jax_tokens(worker.SCHED, r["sched_reqs"])
    for a, b, c in zip(tp["tokens"], base["tokens"], want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_tp_swiglu_scheduler_tokens_equal_jax(ranks):
    """The llama-class net (RMS norm, SwiGLU; mlp_down row-paired through
    the gate) served over the mesh, token for token the JAX scheduler's."""
    r = ranks["two"][0]
    assert r["swiglu_tp"]["disagreements"] == 0
    want = _jax_tokens(worker.SWIGLU, r["swiglu_prompts"])
    for a, b in zip(r["swiglu_tp"]["tokens"], want):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------ ring attention, overlap

@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_equals_jax(ranks, causal):
    """Two ranks' sequence blocks, joined, against the JAX ring over a
    2-device mesh."""
    q, k, v = ranks["two"][0]["ring_in"]
    got = np.concatenate([r["ring"][causal] for r in ranks["two"]], axis=2)
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("data",))
    want = np.asarray(jax_ring(q, k, v, mesh, "data", causal=causal))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _jax_ring(fn, x, w, in_specs, out_spec):
    mesh = JaxMesh(np.array(jax.devices()[:4]), ("model",))
    return np.asarray(jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                            out_specs=out_spec,
                                            check_vma=False))(x, w))


@pytest.mark.parametrize("ring", ["allgather", "allgather_reverse", "int8",
                                  "reducescatter"])
def test_overlap_rings_equal_dense_and_jax(ranks, ring):
    """The rings at p = 4 against the dense product (the JAX tests'
    reference) and the JAX rings on 4 devices."""
    xs = ranks["four"][0]["rings_in"]
    if ring == "reducescatter":
        got = np.concatenate([r["rings"][ring] for r in ranks["four"]])
        x, w = xs["rs"], xs["rs_w"]
        np.testing.assert_allclose(got, x @ w, rtol=1e-4, atol=1e-4)
        want = _jax_ring(lambda a, b: jax_matmul_reducescatter(a, b, "model"),
                         x, w, (P(None, "model"), P("model", None)),
                         P("model", None))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        return
    x, w = (xs["i8"], xs["i8_w"]) if ring == "int8" else (xs["ag"], xs["ag_w"])
    rev = ring == "allgather_reverse"
    want = _jax_ring(lambda a, b: jax_allgather_matmul(a, b, "model",
                                                       reverse=rev),
                     x, w, (P("model", None), P(None, None)), P(None, None))
    for r in ranks["four"]:
        got = r["rings"][ring]
        if ring == "int8":
            assert got.dtype == np.float32
        np.testing.assert_allclose(got, x.astype(np.float32) @ w.astype(
            np.float32), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_overlap_levels_and_the_process_default():
    """The levels' options (aggressive holds default's; no XLA flag name),
    the process default a TP Net reads, and its removal."""
    d = overlap.overlap_compiler_options("default")
    a = overlap.overlap_compiler_options("aggressive")
    assert set(d) < set(a)
    assert not any(k.startswith(("xla", "--")) for k in a)
    with pytest.raises(ValueError):
        overlap.overlap_compiler_options("xla_tpu")
    try:
        assert overlap.enable_collective_overlap("default") is True
        assert overlap.default_compiler_options() == d
        g = pt.GraphBuilder("t")
        x = g.input((4, 8), name="x")
        g.output(g.op("dense", [x, g.param(np.ones((8, 8), np.float32), "w")],
                      axis=1))
        net = pt.Net(g.finish(), device="cpu")
        assert net.compiler_options is None  # a net with no mesh
    finally:
        overlap.enable_collective_overlap(None)
    assert overlap.default_compiler_options() == {}


# ------------------------------------------------------- scaling record

def _hlo_lines(records):
    """HLO text the JAX parser reads, one collective a record."""
    return "\n".join(
        f"  %c{i} = {r['dtype']}[{','.join(map(str, r['shape']))}]{{0}} "
        f"{r['kind']}(%x{i}), replica_groups=[1,{r['group_size']}]"
        f"<=[{r['group_size']}]" for i, r in enumerate(records))


def test_collective_stats_wire_bytes_equal_jax(ranks):
    """The TP-2 ResNet step's record: all-gathers of its column blocks
    (and nothing else: no row pair in a CNN), priced as the JAX parser
    prices the same collectives."""
    r = ranks["four"][0]
    recs, stats = r["records"], r["stats"]
    assert recs and {c["kind"] for c in recs} == {"all-gather"}
    want = jax_stats(_hlo_lines(recs))
    assert len(want) == len(stats)
    for a, b in zip(stats, want):
        assert (a["kind"], a["result_bytes"], a["group_size"]) == (
            b["kind"], b["result_bytes"], b["group_size"])
        assert a["wire_bytes"] == b["wire_bytes"] > 0
    kinds = ["all-reduce", "collective-permute", "reduce-scatter",
             "all-to-all"]
    more = [dict(recs[0], kind=k, group_size=n) for k in kinds
            for n in (2, 4)]
    from anakin_tpu_torch.parallel import collective_stats
    for a, b in zip(collective_stats(more), jax_stats(_hlo_lines(more))):
        assert a == b


def test_analyze_step_and_weak_scaling_report(ranks):
    """`analyze_step` has `analyze_compiled`'s keys; pure data parallelism
    issues no collective in a step, so its weak scaling is 1 at 4 ranks."""
    r = ranks["four"][0]
    a = r["analysis"]
    assert set(a) == {"flops_per_device", "hbm_bytes_per_device",
                      "n_collectives", "wire_bytes_per_device",
                      "t_compute_s", "t_hbm_s", "t_comm_s",
                      "t_step_full_overlap_s", "t_step_no_overlap_s"}
    assert a["flops_per_device"] > 0 and a["t_comm_s"] > 0
    # the record of `prediction` holds one more: the output's gather over
    # `data`, which a step (as a compiled JAX program) leaves sharded
    assert a["n_collectives"] == len(r["records"]) - 1
    assert a["t_step_no_overlap_s"] >= a["t_step_full_overlap_s"]
    rep = r["weak_dp"]
    assert [row["n_devices"] for row in rep["rows"]] == [1, 2, 4]
    assert rep["rows"][-1]["n_collectives"] == 0
    assert rep["efficiency_at_max_full_overlap"] == pytest.approx(1.0)
    assert rep["hw"] == "h100_sxm"


# -------------------------------------------------------- moe, compile

def test_moe_ffn_runs_replicated_under_a_mesh(ranks):
    """No rule shards `moe_ffn` (as in the JAX rules): under a mesh it runs
    whole on each rank, equal to the unsharded net and to the JAX op."""
    from tests.test_ops import run_op

    for r in ranks["two"]:
        got, unsharded, kinds, x, ws = r["moe"]
        assert set(kinds.values()) == {"normal"}
        np.testing.assert_array_equal(got, unsharded)
    want = run_op("moe_ffn", [x] + ws, top_k=2, activation="gelu")[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


def test_int8_row_pair_runs_the_whole_product(ranks):
    """An int8 dense that the rules row-pair behind a column-sharded int8
    dense: its kernel's fused epilogue cannot be split over partial sums,
    so the rank keeps its whole weight and runs the whole product on the
    gathered input; the output equals the unsharded net's bit for bit."""
    for r in ranks["two"]:
        got, want, kinds, whole, shapes = r["int8_pair"]
        np.testing.assert_array_equal(got, want)
        assert kinds == {"dense_2": "col", "dense_4": "normal"}
        assert whole == ["dense_4"]
        assert shapes["w1_1__int8"] == (256, 128)   # the column block
        assert shapes["w2_3__int8"] == (256, 128)   # the whole weight


def test_net_compile_under_a_mesh_raises(ranks):
    assert "cannot capture" in ranks["two"][0]["compile"]


# ------------------------------------------------------------ pipeline

def test_split_graph_equals_jax_node_for_node(resnet_case):
    jg = resnet_case[1]
    g = pt.optimize(build_resnet50(batch=8, image_size=32))
    got, want = split_graph(g, 4), jax_split_graph(jg, 4)
    assert len(got) == 4 and sum(len(s.nodes) for s in got) == len(g.nodes)
    for a, b in zip(got, want):
        assert list(a.nodes) == list(b.nodes)
        assert (a.name, a.inputs, a.outputs, a.input_specs) == (
            b.name, b.inputs, b.outputs, b.input_specs)
        assert sorted(a.params) == sorted(b.params)


@pytest.mark.parametrize("microbatches", [2, 4])
def test_pipelined_net_on_four_cpu_devices(resnet_case, jax_resnet,
                                           microbatches):
    d, jg, x, _ = resnet_case
    g = pt.optimize(build_resnet50(batch=8, image_size=32))
    pnet = PipelinedNet(g, ["cpu"] * 4)
    got = pnet.prediction({"input": x}, microbatches=microbatches)[
        g.outputs[0]].numpy()
    np.testing.assert_allclose(got, jax_resnet["f"], **F32_TOL)
    want = pt.Net(g, device="cpu").prediction({"input": x})[g.outputs[0]]
    np.testing.assert_allclose(got, want.numpy(), **F32_TOL)
