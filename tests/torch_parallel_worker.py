"""One gloo rank of `tests/test_torch_parallel.py`: the port's parallel
package over `torch.distributed` on the CPU, imported without JAX.

    python tests/torch_parallel_worker.py <port> <rank> <world> <suite> <dir>

Each rank joins the group through `parallel.initialize`, runs the suite's
checks (the ResNet-50 and decode-step graphs are built here with the
port's builders from the JAX tests' seeds; int8 scales and inputs come
from `<dir>`), and pickles its results to `<dir>/<suite>_<rank>.pkl`.
"""

import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import anakin_tpu_torch as pt  # noqa: E402
from anakin_tpu_torch.graph.ir import topological_order  # noqa: E402
from anakin_tpu_torch.models import build_resnet50  # noqa: E402
from anakin_tpu_torch.models import transformer as tf  # noqa: E402
from anakin_tpu_torch.parallel import (initialize, is_distributed,  # noqa: E402
                                       local_device_count, make_hybrid_mesh,
                                       make_mesh, ring_attention,
                                       shard_graph_params,
                                       weak_scaling_report)
from anakin_tpu_torch.parallel import overlap  # noqa: E402
from anakin_tpu_torch.parallel.scaling import (analyze_step,  # noqa: E402
                                               collective_stats)
from anakin_tpu_torch.quant import (calibrate, quantize_graph,  # noqa: E402
                                    read_scale_table, weight_only_quantize)
from anakin_tpu_torch.runtime import DecodeScheduler  # noqa: E402

CPU = "cpu"
DECODE = dict(vocab=96, embed=256, heads=8, kv_heads=4, layers=2, max_seq=16)
SCHED = dict(vocab=64, embed=64, heads=4, kv_heads=2, layers=2, max_seq=64)
SWIGLU = dict(vocab=64, embed=128, heads=4, kv_heads=2, layers=2, max_seq=48,
              norm="rms", mlp="swiglu")


def _np(t):
    return t.detach().float().numpy() if t.is_floating_point() else t.numpy()


def _tp_net(g, mesh, **kw):
    return pt.Net(g, device=CPU, mesh=mesh,
                  param_sharding=shard_graph_params(g, mesh), **kw)


def suite_four(rank, d):
    """4 ranks: collectives, meshes, ResNet-50 float and int8 under tp 1,
    2, 4 and a hybrid mesh, the overlap rings at p = 4, the scaling record
    and report."""
    out = {}
    t = torch.full((3,), float(rank + 1))
    torch.distributed.all_reduce(t)
    out["init"] = (is_distributed(), local_device_count(), float(t[0]))

    x = np.load(os.path.join(d, "resnet_x.npy"))
    g = pt.optimize(build_resnet50(batch=8, image_size=32))
    meshes = {"tp1": make_mesh(model=1), "tp2": make_mesh(model=2),
              "tp4": make_mesh(model=4),
              "hybrid": make_hybrid_mesh(dcn=2, model=2)}
    out["mesh_shapes"] = {k: dict(m.shape) for k, m in meshes.items()}
    out["resnet_f"] = {}
    for k, mesh in meshes.items():
        net = _tp_net(g, mesh)
        out["resnet_f"][k] = _np(net.prediction({"input": x})[g.outputs[0]])
        if k == "tp2":
            mesh.take_records()
            net.prediction({"input": x})
            recs = mesh.take_records()
            out["records"] = recs
            out["stats"] = collective_stats(recs)
            out["analysis"] = {k2: v for k2, v in analyze_step(
                net, {"input": x}).items() if k2 != "collectives"}
    out["resnet_f_unsharded"] = _np(pt.Net(g, device=CPU).prediction(
        {"input": x})[g.outputs[0]])

    gq = quantize_graph(g, read_scale_table(os.path.join(d, "scales.txt")))
    int8_edges = [n.outputs[0] for n in topological_order(gq)
                  if n.op in ("conv2d_int8", "dense_int8", "pool2d_int8")]
    out["int8_edges"] = int8_edges
    want = pt.Net(gq, device=CPU, tap_edges=int8_edges).prediction(
        {"input": x})
    out["resnet_q_unsharded"] = {k: _np(v) for k, v in want.items()}
    out["resnet_q"] = {}
    for k in ("tp2", "tp4"):
        got = _tp_net(gq, meshes[k], tap_edges=int8_edges).prediction(
            {"input": x})
        out["resnet_q"][k] = {e: _np(v) for e, v in got.items()}

    ring = make_mesh(model=4)
    rng = np.random.default_rng(11)
    xs = {"ag": rng.standard_normal((64, 32)).astype(np.float32),
          "ag_w": rng.standard_normal((32, 48)).astype(np.float32),
          "rs": rng.standard_normal((64, 128)).astype(np.float32),
          "rs_w": rng.standard_normal((128, 40)).astype(np.float32),
          "i8": rng.integers(-100, 100, (32, 16)).astype(np.int8),
          "i8_w": rng.integers(-100, 100, (16, 24)).astype(np.int8)}
    i = ring.axis_index("model")
    T = {k: torch.from_numpy(v) for k, v in xs.items()}
    out["rings_in"] = xs
    out["rings"] = {
        "allgather": _np(overlap.allgather_matmul(
            T["ag"][i * 16:(i + 1) * 16], T["ag_w"], "model", mesh=ring)),
        "allgather_reverse": _np(overlap.allgather_matmul(
            T["ag"][i * 16:(i + 1) * 16], T["ag_w"], "model", reverse=True,
            mesh=ring)),
        "reducescatter": _np(overlap.matmul_reducescatter(
            T["rs"][:, i * 32:(i + 1) * 32], T["rs_w"][i * 32:(i + 1) * 32],
            "model", mesh=ring)),
        "int8": _np(overlap.allgather_matmul(
            T["i8"][i * 8:(i + 1) * 8], T["i8_w"], "model", mesh=ring)),
    }

    def build(n):
        mesh = make_mesh(devices=list(range(n)), model=1)
        if mesh.coords is None:
            return None
        gb = pt.optimize(build_resnet50(batch=2 * n, image_size=32))
        return (_tp_net(gb, mesh), {"input": np.zeros((2 * n, 32, 32, 3),
                                                      np.float32)})

    out["weak_dp"] = weak_scaling_report(
        build, ns=(1, 2, 4), out_path=os.path.join(d, f"weak_{rank}.json"))
    return out


def _decode_feed(cfg, B, seed):
    rng = np.random.default_rng(seed)
    feed = {"input": rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
            "pos": np.zeros((B,), np.int32)}
    shape = (B, cfg.kv_heads, cfg.max_seq, cfg.head_dim)
    for i in range(cfg.layers):
        feed[f"cache_k_{i}"] = rng.normal(size=shape).astype(np.float32) * 0.1
        feed[f"cache_v_{i}"] = rng.normal(size=shape).astype(np.float32) * 0.1
    return feed


def _serve(cfg, params, reqs, mesh, rank, **kw):
    if mesh is None and rank != 0:
        return None
    sched = DecodeScheduler(cfg, batch=2, params=params, fuse_window=4,
                            mesh=mesh, device=CPU, **kw)
    try:
        if mesh is not None and rank != 0:
            return None
        futs = [sched.submit(p, max_new_tokens=n) for p, n in reqs]
        return {"tokens": [f.result(timeout=300) for f in futs],
                "windows": sched.fused_windows_run,
                "bucket_prefills": sched.bucket_prefills_run,
                "disagreements": sched.token_disagreements}
    finally:
        sched.close()


def suite_two(rank, d):
    """2 ranks: the TP decode step (float, w8, w4 and the embedding, under
    each overlap level), the TP schedulers, ring attention, moe_ffn, and
    `Net.compile` under the mesh."""
    out = {}
    mesh = make_mesh(model=2)
    cfg = tf.TransformerConfig(**DECODE)
    params = tf.make_transformer_params(cfg, 4)
    g = tf.build_transformer_decode_step(cfg, 4, params)
    feed = _decode_feed(cfg, 4, 5)
    graphs = {"float": g, "w8": weight_only_quantize(g, min_elems=1024),
              "w4": weight_only_quantize(g, bits=4, min_elems=1024)}
    out["decode"] = {}
    for k, gg in graphs.items():
        for level in (None, "default", "aggressive"):
            overlap.enable_collective_overlap(level)
            net = _tp_net(gg, mesh)
            mesh.take_records()
            got = net.prediction({e: v.copy() for e, v in feed.items()})
            out["decode"][k, level] = _np(got[gg.outputs[0]])
            out["decode_colls", k, level] = sorted(
                {r["kind"] for r in mesh.take_records()})
            if level is None:
                out["decode_caches", k] = _np(got[gg.outputs[1]])
                out["decode_kinds", k] = dict(net.forward.kinds)
        overlap.enable_collective_overlap(None)
        out["decode_unsharded", k] = _np(pt.Net(gg, device=CPU).prediction(
            {e: v.copy() for e, v in feed.items()})[gg.outputs[0]])
    try:
        _tp_net(g, mesh).compile({e: v.copy() for e, v in feed.items()})
        out["compile"] = "no error"
    except NotImplementedError as e:
        out["compile"] = str(e)

    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 64, (p,)).astype(np.int32), n)
            for p, n in ((5, 8), (11, 6), (3, 10))]
    sp = tf.make_transformer_params(tf.TransformerConfig(**SCHED), 5)
    out["sched_reqs"] = reqs
    out["sched_tp"] = _serve(tf.TransformerConfig(**SCHED), sp, reqs, mesh, rank)
    out["sched_base"] = _serve(tf.TransformerConfig(**SCHED), sp, reqs, None,
                               rank)
    prompts = [(rng.integers(0, 64, (p,)).astype(np.int32), 6) for p in (5, 9)]
    wp = tf.make_transformer_params(tf.TransformerConfig(**SWIGLU), 5)
    out["swiglu_prompts"] = prompts
    out["swiglu_tp"] = _serve(tf.TransformerConfig(**SWIGLU), wp, prompts,
                              mesh, rank)

    seq = make_mesh(model=1)  # the two ranks on `data`
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 4, 32, 16)).astype(np.float32)
               for _ in range(3))
    out["ring_in"] = (q, k, v)
    i = seq.axis_index("data")
    blk = [torch.from_numpy(a[:, :, i * 16:(i + 1) * 16]) for a in (q, k, v)]
    out["ring"] = {c: _np(ring_attention(*blk, seq, "data", causal=c))
                   for c in (False, True)}

    gb = pt.GraphBuilder("mlp8")
    xi = gb.input((4, 256), name="x")
    rng = np.random.default_rng(9)
    h = gb.op("dense", [xi, gb.param(rng.normal(size=(256, 256)).astype(
        np.float32) * 0.1, "w1")], axis=1, activation="relu")
    gb.output(gb.op("dense", [h, gb.param(rng.normal(size=(256, 128)).astype(
        np.float32) * 0.1, "w2")], axis=1))
    g8 = gb.finish()
    x8 = rng.normal(size=(4, 256)).astype(np.float32)
    g8 = quantize_graph(g8, calibrate(g8, [{"x": x8}], method="max",
                                      device=CPU))
    net = _tp_net(g8, mesh)
    out["int8_pair"] = (_np(net.prediction({"x": x8})[g8.outputs[0]]),
                        _np(pt.Net(g8, device=CPU).prediction({"x": x8})
                            [g8.outputs[0]]),
                        dict(net.forward.kinds), net.forward.replicated_int8,
                        {e: tuple(v.shape) for e, v in net.params.items()})

    gm = pt.GraphBuilder("moe")
    xm = gm.input((2, 3, 8), name="x")
    rng = np.random.default_rng(2)
    w_np = [rng.normal(size=s).astype(np.float32) * sc
            for s, sc in (((8, 4), 1.0), ((4, 8, 16), 0.2), ((4, 16, 8), 0.2))]
    ws = [gm.param(w, n) for w, n in zip(w_np, ("w_gate", "w_up", "w_down"))]
    gm.output(gm.op("moe_ffn", [xm] + ws, top_k=2, activation="gelu"))
    gm = gm.finish()
    xin = rng.normal(size=(2, 3, 8)).astype(np.float32)
    net = _tp_net(gm, mesh)
    out["moe"] = (_np(net.prediction({"x": xin})[gm.outputs[0]]),
                  _np(pt.Net(gm, device=CPU).prediction({"x": xin})
                      [gm.outputs[0]]),
                  dict(net.forward.kinds), xin, w_np)
    return out


def main():
    port, rank, world, suite, d = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    initialize(f"localhost:{port}", num_processes=world, process_id=rank)
    out = {"four": suite_four, "two": suite_two}[suite](rank, d)
    with open(os.path.join(d, f"{suite}_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"WORKER_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
