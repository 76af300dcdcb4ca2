"""Runtime and serving of the port (`graph/passes/memory.py`,
`graph/visualize.py`, `runtime/worker.py`, `serving/`) against the JAX
package, on the CPU, at the JAX tests' sizes: ResNet-50 and MobileNet v1
(10 classes) at 32 px, the transformer of `tests/test_serving.py` (vocab
40, E 64, 4 heads over 2, 2 layers, max_seq 24).

Tolerances, and why:
  * the arena plan and the visualization text: equal (offsets, sizes,
    reuse map; the text byte for byte), since both come from the graph and
    its shapes and dtypes; an int64 edge is the one place where the port's
    dtypes part from JAX's (JAX narrows it to int32), and there the test
    states the difference;
  * a Worker's or a batcher's outputs against the port's own `Net` of the
    same batch: bit-equal (the same code on the same inputs); against the
    JAX `Net`: the softmax within rtol 5e-3 / atol 1e-4, the tolerance of
    `tests/test_torch_resnet.py`;
  * generated tokens: equal to the JAX service's (greedy, float32 on both
    sides);
  * a server in another process: within rtol 1e-6 of the in-process `Net`
    (the same ops, but the CPU's thread pool may split a sum otherwise).
"""

import os
import socket
import subprocess
import sys
import threading
import time

import grpc
import ml_dtypes
import numpy as np
import pytest
import torch

import anakin_tpu as ak
from anakin_tpu.graph import visualize as jax_visualize
from anakin_tpu.graph.passes.memory import plan_memory as jax_plan_memory
from anakin_tpu.models import build_mobilenet_v1 as jax_build_mobilenet_v1
from anakin_tpu.models import build_resnet50 as jax_build_resnet50
from anakin_tpu.models import transformer as jax_tf
from anakin_tpu.quant import apply_precision_policy as jax_apply_policy
from anakin_tpu.quant import quantize_graph as jax_quantize_graph
from anakin_tpu.runtime.decode_scheduler import DecodeScheduler as JaxScheduler
from anakin_tpu.serving import AnakinService as JaxService
from anakin_tpu.serving import ContinuousBatcher as JaxBatcher
from anakin_tpu.serving import DeviceStatus as JaxDeviceStatus
from anakin_tpu.serving import RpcClient as JaxClient
from anakin_tpu.serving import serve as jax_serve
import anakin_tpu_torch as pt
from anakin_tpu_torch.convert import graph_from_jax, to_numpy
from anakin_tpu_torch.graph import GraphBuilder, topological_order
from anakin_tpu_torch.graph import visualize
from anakin_tpu_torch.graph.passes.memory import plan_memory
from anakin_tpu_torch.model_io import save_model
from anakin_tpu_torch.models import build_mobilenet_v1, build_resnet50
from anakin_tpu_torch.models import transformer as pt_tf
from anakin_tpu_torch.quant import calibrate
from anakin_tpu_torch.runtime import DecodeScheduler, Worker
from anakin_tpu_torch.serving import (AnakinService, ContinuousBatcher,
                                      DeviceMonitor, DeviceStatus, RpcClient,
                                      serve)
from anakin_tpu_torch.serving.daemon import ServerSpec, ServingDaemon
from anakin_tpu_torch.serving.server import main as server_main
from anakin_tpu_torch.serving.server import make_net_factory, with_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
SOFTMAX_TOL = dict(rtol=5e-3, atol=1e-4)   # tests/test_torch_resnet.py
LLM = dict(vocab=40, embed=64, heads=4, kv_heads=2, layers=2, max_seq=24)


def _images(seed, n, size=32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(size, size, 3)).astype(np.float32)
            for _ in range(n)]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_until(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout} s")
        threading.Event().wait(0.05)


# ----------------------------------------------------------------- graphs

@pytest.fixture(scope="module")
def resnet():
    """(port graph, JAX graph): ResNet-50, b1, 32 px, optimized."""
    return (pt.optimize(build_resnet50(batch=1, image_size=32)),
            ak.optimize(jax_build_resnet50(batch=1, image_size=32)))


@pytest.fixture(scope="module")
def mobilenet():
    """(port graph, JAX graph, scales): MobileNet v1, b1, 32 px, 10
    classes, optimized; scales from the port's max calibration."""
    g = pt.optimize(build_mobilenet_v1(batch=1, image_size=32, num_classes=10))
    jg = ak.optimize(jax_build_mobilenet_v1(batch=1, image_size=32,
                                            num_classes=10))
    scales = calibrate(g, [{"input": x[None]} for x in _images(3, 2)],
                       method="max", device=CPU)
    return g, jg, scales


@pytest.fixture(scope="module")
def jax_resnet_net(resnet):
    return ak.Net(resnet[1])


def _transformer_graphs():
    kw = dict(batch=2, seq_len=16, seed=6)
    return (pt_tf.build_transformer_prefill(pt_tf.TransformerConfig(**LLM), **kw),
            jax_tf.build_transformer_prefill(jax_tf.TransformerConfig(**LLM), **kw))


def _int64_graphs():
    """A graph fed int64 token ids (4 x 128), reshaped and looked up: the
    port keeps the reshape's output int64, JAX makes it int32."""
    out = []
    for GB in (GraphBuilder, ak.GraphBuilder):
        b = GB("ids64")
        ids = b.input((4, 128), dtype="int64", name="ids")
        table = b.param(np.random.default_rng(0).normal(size=(50, 16))
                        .astype(np.float32), "table")
        flat = b.op("reshape", [ids], shape=(512,))
        b.output(b.op("embedding", [flat, table]))
        out.append(b.finish())
    return out


def _graphs(name, resnet, mobilenet):
    if name == "resnet50":
        return resnet
    if name == "mobilenet_v1":
        return mobilenet[:2]
    if name == "transformer":
        return _transformer_graphs()
    return _int64_graphs()


# --------------------------------------------------------------- the plan

@pytest.mark.parametrize("name", ["resnet50", "mobilenet_v1", "transformer"])
def test_plan_memory_equals_jax(name, resnet, mobilenet):
    g, jg = _graphs(name, resnet, mobilenet)
    got, want = plan_memory(g), jax_plan_memory(jg)
    assert got.offsets == want.offsets
    assert got.sizes == want.sizes
    assert got.share_from == want.share_from
    assert (got.arena_bytes, got.naive_bytes) == (want.arena_bytes,
                                                  want.naive_bytes)
    assert got.summary() == want.summary()
    assert got.arena_bytes < got.naive_bytes


@pytest.mark.parametrize("name", ["resnet50", "mobilenet_v1", "transformer",
                                  "int64_ids"])
def test_port_plan_has_no_liveness_overlap(name, resnet, mobilenet):
    """Two edges that share storage are never live at once; every block
    lies in the arena, aligned (`tests/test_runtime.py`'s checks)."""
    g = _graphs(name, resnet, mobilenet)[0]
    plan = plan_memory(g)
    order = topological_order(g)
    step_of = {n.name: i for i, n in enumerate(order)}
    consumers, producers = g.consumers(), g.producers()

    def live_range(e):
        birth = step_of[producers[e].name] if e in producers else -1
        death = max((step_of[c.name] for c in consumers.get(e, [])),
                    default=birth)
        return birth, len(order) if e in g.outputs else death

    by_offset = {}
    for e, off in plan.offsets.items():
        assert off % 512 == 0 and off + plan.sizes[e] <= plan.arena_bytes
        by_offset.setdefault(off, []).append(e)
    for off, edges in by_offset.items():
        ranges = sorted(live_range(e) for e in edges)
        for (b1, d1), (b2, d2) in zip(ranges, ranges[1:]):
            assert d1 <= b2, f"overlap at offset {off}: {ranges}"


def test_int64_edges_take_twice_the_jax_plans_bytes():
    """The one edge made from the int64 ids is int64 in the port and int32
    in JAX: 4096 bytes against 2048; the input (int64 in both) and the
    float edge are equal, and the offsets follow from the sizes."""
    g, jg = _int64_graphs()
    got, want = plan_memory(g), jax_plan_memory(jg)
    differ = {e: (got.sizes[e], want.sizes[e]) for e in got.sizes
              if got.sizes[e] != want.sizes[e]}
    assert differ == {"reshape_2:out": (4096, 2048)}
    assert got.sizes["ids"] == want.sizes["ids"] == 4096
    assert got.arena_bytes == want.arena_bytes + 2048


# --------------------------------------------------------- visualization

@pytest.mark.parametrize("fn", ["to_dot", "to_json", "summary_table"])
@pytest.mark.parametrize("name", ["resnet50", "mobilenet_v1_int8"])
def test_visualization_text_equals_jax(fn, name, resnet, mobilenet):
    """Float graphs built by each package; the int8 graph is the JAX
    package's quantized MobileNet handed to the port (the same attrs)."""
    if name == "resnet50":
        g, jg = resnet
    else:
        jg = jax_quantize_graph(mobilenet[1], mobilenet[2])
        g = graph_from_jax(jg)
    assert getattr(visualize, fn)(g) == getattr(jax_visualize, fn)(jg)


def test_to_json_writes_its_text(tmp_path, resnet):
    path = str(tmp_path / "g.json")
    text = visualize.to_json(resnet[0], path)
    with open(path) as f:
        assert f.read() == text


# ----------------------------------------------------------------- Worker

def test_worker_sync_async_and_latencies(resnet, jax_resnet_net):
    g, jg = resnet
    net = pt.Net(g, device=CPU)
    w = Worker(net, num_threads=3)
    feeds = [{"input": x[None]} for x in _images(11, 6)]
    out = g.outputs[0]
    try:
        outs = [f.result(timeout=60) for f in
                [w.sync_prediction(f) for f in feeds]]
        for o, f in zip(outs, feeds):
            assert isinstance(o[out], np.ndarray) and o[out].shape == (1, 1000)
            np.testing.assert_array_equal(o[out],
                                          net.prediction(f)[out].numpy())
            np.testing.assert_allclose(
                o[out], np.asarray(jax_resnet_net.prediction(f)[jg.outputs[0]]),
                **SOFTMAX_TOL)
        dev = w.sync_prediction_device(feeds[0]).result(timeout=60)
        assert isinstance(dev[out], torch.Tensor)
        assert dev[out].device == net.device
        for f in feeds:
            w.async_prediction(f)
        ordered = [w.async_get_result(timeout=60) for _ in feeds]
        for o, want in zip(ordered, outs):   # FIFO: submission order
            np.testing.assert_array_equal(o[out], want[out])
        assert len(w.prediction_times_ms()) == 13
        assert all(t > 0 for t in w.prediction_times_ms())
    finally:
        w.shutdown()


def test_worker_op_timer_counts_every_threads_nodes(mobilenet):
    """The op timer's node in flight is each thread's own: three threads
    over one timed net count every node once a request."""
    net = pt.Net(mobilenet[0], device=CPU, enable_op_timer=True)
    w = Worker(net, num_threads=3)
    feeds = [{"input": x[None]} for x in _images(12, 9)]
    try:
        for f in [w.sync_prediction(f) for f in feeds]:
            f.result(timeout=60)
    finally:
        w.shutdown()
    lines = net.print_and_reset_optime_summary().splitlines()[:-1]
    assert len(lines) == len(mobilenet[0].nodes)
    assert all(line.endswith("(n=9)") for line in lines)


def test_aux_functions_run_once_a_request(mobilenet):
    calls = []
    w = Worker(pt.Net(mobilenet[0], device=CPU))
    w.register_aux_function(lambda: calls.append(1))
    try:
        for f in [w.sync_prediction({"input": x[None]})
                  for x in _images(13, 3)]:
            f.result(timeout=60)
    finally:
        w.shutdown()
    assert len(calls) == 3


# ---------------------------------------------------------------- batcher

def _factory(g, precision="fp32"):
    return lambda batch: pt.Net(with_batch(g, batch), precision=precision,
                                device=CPU)


def _batches(xs, sizes, buckets):
    """The padded batches the batcher ran: requests are taken in
    submission order, `sizes` from `batch_sizes_served()`."""
    out, i = [], 0
    for n in sizes:
        bucket = next(b for b in sorted(buckets) if b >= n)
        stacked = np.stack(xs[i:i + n])
        out.append((i, n, bucket, np.pad(stacked, [(0, bucket - n)] +
                                          [(0, 0)] * 3)))
        i += n
    return out


def test_batcher_equals_same_bucket_nets_and_jax(resnet, jax_resnet_net):
    g, jg = resnet
    buckets = (1, 2, 4)
    b = ContinuousBatcher(_factory(g), ["input"], buckets=buckets,
                          max_delay_ms=20.0)
    xs = _images(21, 6)
    try:
        outs = [f.result(timeout=120) for f in
                [b.submit({"input": x}) for x in xs]]
        sizes = b.batch_sizes_served()
    finally:
        b.shutdown()
    assert sum(sizes) == 6 and max(sizes) >= 2
    out = g.outputs[0]
    nets = {}
    for i, n, bucket, batch in _batches(xs, sizes, buckets):
        net = nets.setdefault(bucket, _factory(g)(bucket))
        want = net.prediction({"input": batch})[out].numpy()
        for j in range(n):
            assert outs[i + j][out].shape == (1000,)
            np.testing.assert_array_equal(outs[i + j][out], want[j])
    for x, o in zip(xs, outs):
        np.testing.assert_allclose(
            o[out], np.asarray(jax_resnet_net.prediction(
                {"input": x[None]})[jg.outputs[0]])[0], **SOFTMAX_TOL)


def test_bf16_batcher_outputs_reach_the_host_as_bfloat16(mobilenet):
    """A bf16 net's outputs come back as ml_dtypes' bfloat16, as the JAX
    batcher's `np.asarray` of a bf16 array gives, bit-equal to the net's."""
    g = mobilenet[0]
    b = ContinuousBatcher(_factory(g, "bf16"), ["input"], buckets=(1, 2),
                          max_delay_ms=20.0)
    xs = _images(22, 2)
    try:
        outs = [f.result(timeout=60) for f in
                [b.submit({"input": x}) for x in xs]]
        sizes = b.batch_sizes_served()
    finally:
        b.shutdown()
    out = g.outputs[0]
    for i, n, bucket, batch in _batches(xs, sizes, (1, 2)):
        want = to_numpy(_factory(g, "bf16")(bucket).prediction(
            {"input": batch})[out])
        assert want.dtype == ml_dtypes.bfloat16
        for j in range(n):
            assert outs[i + j][out].dtype == ml_dtypes.bfloat16
            assert outs[i + j][out].tobytes() == want[j].tobytes()


def test_to_numpy_gives_what_numpy_of_a_jax_array_gives():
    import jax.numpy as jnp

    x = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32,
                                                     jnp.float32),
                    (torch.int8, jnp.int8)):
        got = to_numpy(torch.from_numpy(x).to(dt))
        want = np.asarray(jnp.asarray(x).astype(jdt))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_raising_factory_fails_its_batch_and_the_next_is_served(mobilenet):
    """ROADMAP §3 item 23: a factory that raises fails that batch's futures
    with its error, and the dispatcher serves the next batch."""
    g = mobilenet[0]
    built = []

    def factory(batch):
        built.append(batch)
        if len(built) == 1:
            raise RuntimeError("no net for you")
        return _factory(g)(batch)

    b = ContinuousBatcher(factory, ["input"], buckets=(1,), max_delay_ms=0.0)
    x = _images(23, 1)[0]
    try:
        with pytest.raises(RuntimeError, match="no net for you"):
            b.submit({"input": x}).result(timeout=30)
        got = b.submit({"input": x}).result(timeout=30)
        assert b._thread.is_alive()
    finally:
        b.shutdown()
    np.testing.assert_array_equal(
        got[g.outputs[0]],
        _factory(g)(1).prediction({"input": x[None]})[g.outputs[0]].numpy()[0])
    assert b.batch_sizes_served() == [1, 1]


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_jax_batcher_dies_on_a_raising_factory(mobilenet):
    """The reference fault the port does not copy: the JAX `_loop` builds
    the net outside its `try`, so the dispatcher thread ends and the
    request's future is never resolved (`evaluate` would wait its 120 s)."""
    def factory(batch):
        raise RuntimeError("no net")

    b = JaxBatcher(factory, ["input"], buckets=(1,), max_delay_ms=0.0)
    fut = b.submit({"input": _images(24, 1)[0]})
    b._thread.join(timeout=30)
    assert not b._thread.is_alive()
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.5)
    assert not fut.done()


class _EchoNet:
    """A stand-in net: returns its input's rows, as `to_tensor` makes them,
    once `gate` is set; `entered` is set when a batch reaches it."""

    def __init__(self, gate, entered, to_tensor):
        self.gate, self.entered, self.to_tensor = gate, entered, to_tensor

    def prediction(self, feed):
        self.entered.set()
        self.gate.wait(timeout=30)
        return {"y": self.to_tensor(feed["x"])}


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_backlog_older_than_the_window_is_batched(package):
    """ROADMAP §3 item 24: requests that queued while a batch ran join the
    next batch even though their window has passed.  The JAX `_take_batch`
    stops at the window's end, so it serves such a backlog one request a
    batch; the port takes it whole."""
    gate, entered = threading.Event(), threading.Event()
    to_tensor = torch.from_numpy if package == "port" else np.asarray
    batcher = ContinuousBatcher if package == "port" else JaxBatcher
    b = batcher(lambda n: _EchoNet(gate, entered, to_tensor), ["x"],
                buckets=(1, 2, 4, 8), max_delay_ms=0.0)
    try:
        futs = [b.submit({"x": np.full((3,), 0.0, np.float32)})]
        assert entered.wait(timeout=30)  # the first batch is running
        futs += [b.submit({"x": np.full((3,), float(i), np.float32)})
                 for i in range(1, 7)]
        gate.set()
        outs = [f.result(timeout=30) for f in futs]
    finally:
        b.shutdown()
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o["y"], np.full((3,), float(i)))
    want = [1, 6] if package == "port" else [1] * 7
    assert b.batch_sizes_served() == want


class _RaisingNet:
    def prediction(self, feed):
        raise RuntimeError("forward failed")


@pytest.mark.parametrize("net", ["echo", "raising"])
def test_batch_sizes_are_recorded_before_the_futures_resolve(net):
    """ROADMAP §3 item 25: a caller that waits on every future and then
    reads `batch_sizes_served()` sees every batch, round after round, for
    batches that succeed and for batches that fail (the JAX batcher
    records a size after resolving its futures)."""
    gate = threading.Event()
    gate.set()
    factory = ((lambda n: _EchoNet(gate, threading.Event(), torch.from_numpy))
               if net == "echo" else (lambda n: _RaisingNet()))
    b = ContinuousBatcher(factory, ["x"], buckets=(1, 2, 4, 8),
                          max_delay_ms=1.0)
    try:
        for r in range(50):
            futs = [b.submit({"x": np.full((3,), float(i), np.float32)})
                    for i in range(6)]
            for f in futs:
                if net == "echo":
                    f.result(timeout=30)
                else:
                    with pytest.raises(RuntimeError, match="forward failed"):
                        f.result(timeout=30)
            assert sum(b.batch_sizes_served()) == 6 * (r + 1), r
    finally:
        b.shutdown()


# ---------------------------------------------------------------- monitor

def test_monitor_status_keys_equal_jax_and_cpu_counts_are_unset():
    m = DeviceMonitor(interval_s=0.02, device=CPU).start()
    try:
        first = m.status().sampled_at
        _wait_until(lambda: m.status().sampled_at > first, 10, "a new sample")
    finally:
        m.stop()
    st = m.status()
    assert list(st.to_dict()) == list(JaxDeviceStatus().to_dict())
    assert list(DeviceStatus().to_dict().values()) == \
        list(JaxDeviceStatus().to_dict().values())
    assert (st.device, st.platform) == ("cpu", "cpu")
    assert (st.bytes_in_use, st.bytes_limit, st.peak_bytes_in_use) == (-1,) * 3
    assert not m._thread.is_alive()


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_monitor_and_service_default_to_cuda():
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceMonitor()
    with pytest.raises(RuntimeError, match="CUDA"):
        AnakinService()


def test_server_defaults_to_cuda(tmp_path, mobilenet):
    _no_cuda()
    save_model(mobilenet[0], str(tmp_path / "m"))
    with pytest.raises(RuntimeError, match="CUDA"):
        server_main(["--model-dir", str(tmp_path / "m"), "--port", "0"])


def test_server_overlap_waits_for_the_parallelism_slice(tmp_path):
    """`--overlap` installs the process default of `parallel.overlap`
    before the model loads (here a directory with no model, which then
    raises)."""
    from anakin_tpu_torch.parallel import overlap

    try:
        with pytest.raises(FileNotFoundError):
            server_main(["--model-dir", str(tmp_path), "--overlap",
                         "aggressive", "--device", CPU])
        assert overlap.default_compiler_options() == \
            overlap.overlap_compiler_options("aggressive")
    finally:
        overlap.enable_collective_overlap(None)


# ------------------------------------------------------------------- RPC

@pytest.fixture(scope="module")
def llm_params():
    return pt_tf.make_transformer_params(pt_tf.TransformerConfig(**LLM), 6)


@pytest.fixture(scope="module")
def port_server(mobilenet, llm_params):
    """The port's service on a socket: MobileNet fp32 as "mn" (buckets 1,
    2), bf16 as "mn16", and the transformer's scheduler as "lm"."""
    g = mobilenet[0]
    svc = AnakinService(DeviceMonitor(interval_s=0.05, device=CPU).start())
    svc.initial("mn", ContinuousBatcher(_factory(g), ["input"],
                                        buckets=(1, 2), max_delay_ms=5.0))
    svc.initial("mn16", ContinuousBatcher(_factory(g, "bf16"), ["input"],
                                          buckets=(1,), max_delay_ms=0.0))
    svc.initial_llm("lm", DecodeScheduler(pt_tf.TransformerConfig(**LLM),
                                          batch=2, params=llm_params,
                                          device=CPU))
    server = serve(svc, port=0)
    yield svc, f"127.0.0.1:{server._bound_port}"
    server.stop(0).wait(10)
    svc.shutdown()


@pytest.fixture(scope="module")
def jax_server(mobilenet, llm_params):
    """The JAX service on a socket: MobileNet fp32 as "mn" (bucket 1) and
    its scheduler on the same params as "lm"."""
    jg = mobilenet[1]
    svc = JaxService()
    svc.initial("mn", JaxBatcher(lambda batch: ak.Net(jg), ["input"],
                                 buckets=(1,), max_delay_ms=0.0))
    svc.initial_llm("lm", JaxScheduler(jax_tf.TransformerConfig(**LLM),
                                       batch=2, params=llm_params))
    server = jax_serve(svc, port=0)
    yield svc, f"127.0.0.1:{server._bound_port}"
    server.stop(0).wait(10)
    svc.shutdown()


def test_rpc_evaluate_list_models_and_not_found(port_server, mobilenet):
    svc, target = port_server
    g = mobilenet[0]
    client = RpcClient(target)
    try:
        assert client.list_models() == ["mn", "mn16"]
        xs = _images(31, 3)
        resps = [None] * 3

        def call(i):
            resps[i] = client.evaluate("mn", {"input": xs[i]}, request_id=i)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        [t.start() for t in threads]
        [t.join(timeout=60) for t in threads]
        net = pt.Net(g, device=CPU)
        for i, r in enumerate(resps):
            assert r["request_id"] == i and r["info"]["duration_ms"] > 0
            assert list(r["info"]["device_status"]) == \
                list(JaxDeviceStatus().to_dict())
            y = r["outputs"][g.outputs[0]]
            assert y.shape == (10,) and y.dtype == np.float32
            np.testing.assert_allclose(
                y, net.prediction({"input": xs[i][None]})[g.outputs[0]]
                .numpy()[0], rtol=1e-5, atol=1e-6)
        r16 = client.evaluate("mn16", {"input": xs[0]})
        assert r16["outputs"][g.outputs[0]].dtype == ml_dtypes.bfloat16
        for call_ in (lambda: client.evaluate("nope", {"input": xs[0]}),
                      lambda: client.generate("nope", [1, 2]),
                      lambda: list(client.generate_stream("nope", [1, 2]))):
            with pytest.raises(grpc.RpcError) as err:
                call_()
            assert err.value.code() == grpc.StatusCode.NOT_FOUND
    finally:
        client.close()


def test_rpc_generate_tokens_equal_the_jax_service(port_server, jax_server):
    client = RpcClient(port_server[1])
    prompts = [[3, 9, 1], [7, 2, 5, 11, 30]]
    try:
        for i, p in enumerate(prompts):
            got = client.generate("lm", p, max_new_tokens=6, request_id=i)
            want = jax_server[0].generate(
                {"model": "lm", "prompt": p, "max_new_tokens": 6})
            assert got["request_id"] == i
            assert got["tokens"] == want["tokens"]
            assert got["tokens"][:len(p)] == p and len(got["tokens"]) == \
                len(p) + 6
    finally:
        client.close()


def test_rpc_generate_stream_frames_and_stop_tokens(port_server):
    client = RpcClient(port_server[1])
    prompt = [3, 9, 1]
    try:
        frames = list(client.generate_stream("lm", prompt, max_new_tokens=5))
        tokens = [f["token"] for f in frames if "token" in f]
        final = frames[-1]
        assert final.get("done") and len(tokens) == 5
        assert final["tokens"] == prompt + tokens
        stop = next(t for i, t in enumerate(tokens) if t not in tokens[:i]
                    and i >= 1)
        k = tokens.index(stop)
        resp = client.generate("lm", prompt, max_new_tokens=5,
                               stop_tokens=[stop])
        assert resp["tokens"] == final["tokens"][:len(prompt) + k + 1]
    finally:
        client.close()


def test_rpc_service_in_process_equals_the_wire(port_server):
    svc = port_server[0]
    req = {"model": "lm", "prompt": [4, 4, 8], "max_new_tokens": 4}
    frames = list(svc.generate_stream(req))
    client = RpcClient(port_server[1])
    try:
        assert svc.generate(req)["tokens"] == frames[-1]["tokens"] == \
            client.generate("lm", [4, 4, 8], max_new_tokens=4)["tokens"]
    finally:
        client.close()


def test_wire_jax_client_to_the_port_server(port_server, mobilenet):
    """A JAX client gets from the port's server what the port's client
    gets: outputs, model list, tokens, stream frames."""
    jc, pc = JaxClient(port_server[1]), RpcClient(port_server[1])
    x = _images(41, 1)[0]
    try:
        assert jc.list_models() == pc.list_models()
        for model in ("mn", "mn16"):
            a = jc.evaluate(model, {"input": x}, request_id=5)
            b = pc.evaluate(model, {"input": x}, request_id=5)
            assert a["request_id"] == b["request_id"] == 5
            for k, v in b["outputs"].items():
                assert a["outputs"][k].dtype == v.dtype
                assert a["outputs"][k].tobytes() == v.tobytes()
        assert jc.generate("lm", [3, 9, 1], 5)["tokens"] == \
            pc.generate("lm", [3, 9, 1], 5)["tokens"]
        strip = lambda fs: [{k: v for k, v in f.items() if k != "info"}
                            for f in fs]
        assert strip(jc.generate_stream("lm", [3, 9, 1], 5)) == \
            strip(pc.generate_stream("lm", [3, 9, 1], 5))
    finally:
        jc.close()
        pc.close()


def test_wire_port_client_to_the_jax_server(jax_server, mobilenet):
    jc, pc = JaxClient(jax_server[1]), RpcClient(jax_server[1])
    x = _images(42, 1)[0]
    out = mobilenet[1].outputs[0]
    try:
        assert pc.list_models() == jc.list_models() == ["mn"]
        a = pc.evaluate("mn", {"input": x}, request_id=3)
        b = jc.evaluate("mn", {"input": x}, request_id=3)
        assert a["request_id"] == 3
        assert a["outputs"][out].tobytes() == b["outputs"][out].tobytes()
        assert pc.generate("lm", [7, 2, 5], 4)["tokens"] == \
            jc.generate("lm", [7, 2, 5], 4)["tokens"]
        frames = list(pc.generate_stream("lm", [7, 2, 5], 4))
        assert frames[-1]["tokens"][3:] == [f["token"] for f in frames[:-1]]
        with pytest.raises(grpc.RpcError) as err:
            pc.evaluate("nope", {"input": x})
        assert err.value.code() == grpc.StatusCode.NOT_FOUND
    finally:
        jc.close()
        pc.close()


# ----------------------------------------------------------------- server

def test_auto_precision_chooses_per_bucket_as_the_jax_server(mobilenet):
    """`--precision auto`: the choice at each bucket is what the JAX
    server's `apply_precision_policy` call gives on the same graph and
    scales (MobileNet is depthwise-dominated: bf16 below batch 4)."""
    g, jg, scales = mobilenet
    g, jg = g.clone(), jg.clone()
    g.scales, jg.scales = dict(scales), dict(scales)
    chosen = []
    factory = make_net_factory(g, "auto", CPU, log=chosen.append)
    buckets = (1, 2, 4, 8)
    nets = [factory(b) for b in buckets]
    want = [jax_apply_policy(with_batch(jg, b), b, jg.scales)[1]
            for b in buckets]
    assert chosen == [f"precision policy: batch {b} -> {w}"
                      for b, w in zip(buckets, want)]
    assert want == ["bf16", "bf16", "int8", "int8"]
    for net, w in zip(nets, want):
        int8 = any(n.op.endswith("_int8") for n in net.graph.nodes.values())
        assert int8 == (w == "int8") and net.precision == "bf16"


def test_bucket_nets_equal_fresh_nets(mobilenet):
    """The factory's net of a bucket is a `Net` of the graph at that batch,
    with the weights it was given."""
    g = mobilenet[0]
    factory = make_net_factory(g, "bf16", CPU)
    n1, n2 = factory(1), factory(2)
    assert n1.graph.input_specs["input"][0][0] == 1
    assert n2.graph.input_specs["input"][0][0] == 2
    assert all(torch.equal(n2.params[k], n1.params[k]) for k in g.params)
    x = np.stack(_images(51, 2))
    fresh = pt.Net(with_batch(g, 2), precision="bf16", device=CPU)
    out = g.outputs[0]
    assert torch.equal(n2.prediction({"input": x})[out],
                       fresh.prediction({"input": x})[out])


@pytest.mark.parametrize("argv", [False, True])
def test_int8_precision_is_refused_naming_item_23(tmp_path, mobilenet, argv):
    """`--precision int8`, which the JAX server offers and no JAX `Net`
    takes (ROADMAP §3 item 23), is refused before any net is built, by the
    factory and by the server's command line, with the error naming the
    item and the converter's quantized directory."""
    g, jg, scales = mobilenet
    with pytest.raises(KeyError):
        ak.Net(jg, precision="int8")
    with pytest.raises(ValueError, match=r"item 23") as e:
        if argv:
            save_model(g, str(tmp_path / "m"))
            server_main(["--model-dir", str(tmp_path / "m"), "--precision",
                         "int8", "--device", CPU])
        else:
            make_net_factory(g, "int8", CPU)
    assert "converter" in str(e.value)


# ----------------------------------------------------------------- daemon

def test_daemon_starts_serves_restarts_and_stops(tmp_path, mobilenet):
    """A port server process under the daemon on the CPU: it serves, its
    child is terminated, the daemon starts another that serves again, and
    `stop` ends it.  Every wait is on a condition, with a deadline."""
    g = mobilenet[0]
    save_model(g, str(tmp_path / "m"))
    port = _free_port()
    daemon = ServingDaemon([ServerSpec(
        model_dir=str(tmp_path / "m"), name="mn", port=port,
        extra_args=["--buckets", "1,2", "--device", CPU])])
    x = _images(61, 1)[0]
    want = pt.Net(g, precision="bf16", device=CPU).prediction(
        {"input": x[None]})[g.outputs[0]].float().numpy()[0]

    def evaluate():
        client = RpcClient(f"127.0.0.1:{port}")
        try:
            client.wait_ready(timeout=60)
            return client.evaluate("mn", {"input": x})
        finally:
            client.close()

    daemon.start()
    try:
        resp = evaluate()
        got = resp["outputs"][g.outputs[0]]
        assert got.dtype == ml_dtypes.bfloat16
        np.testing.assert_allclose(got.astype(np.float32), want, rtol=1e-6)
        assert resp["info"]["device_status"]["platform"] == "cpu"
        first = daemon._procs[0]
        first.terminate()
        first.wait(timeout=30)
        _wait_until(lambda: daemon.restarts()[0] == 1 and daemon.alive()[0]
                    and daemon._procs[0] is not first, 30, "the restart")
        again = evaluate()["outputs"][g.outputs[0]]
        assert again.tobytes() == got.tobytes()
    finally:
        daemon.stop()
    assert not any(daemon.alive().values())
    assert not daemon._thread.is_alive()


def test_server_sigterm_exit_stays_within_its_bound(tmp_path, mobilenet):
    """ROADMAP §3 item 26: a serving process ends within the sum of its
    exit deadlines after SIGTERM (its own count), and within the daemon's
    wait for a terminated child (the wall clock here)."""
    from anakin_tpu_torch.serving.daemon import TERM_WAIT_S
    from anakin_tpu_torch.serving.server import EXIT_STEPS_S

    budget = sum(EXIT_STEPS_S.values())
    assert budget <= TERM_WAIT_S / 2
    save_model(mobilenet[0], str(tmp_path / "m"))
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "anakin_tpu_torch.serving.server",
         "--model-dir", str(tmp_path / "m"), "--port", str(port),
         "--buckets", "1", "--device", CPU],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        client = RpcClient(f"127.0.0.1:{port}")
        try:
            client.wait_ready(timeout=60)
            client.evaluate("model", {"input": _images(62, 1)[0]})
        finally:
            client.close()
        t0 = time.monotonic()
        proc.terminate()
        out, _ = proc.communicate(timeout=TERM_WAIT_S)
        wall = time.monotonic() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    line = [ln for ln in out.splitlines() if "exit in" in ln]
    assert line, out
    took = float(line[-1].split("exit in ")[1].split(" s")[0])
    assert took <= budget + 0.5, line
    assert wall < TERM_WAIT_S, (wall, line)


def test_serving_is_not_imported_by_the_package():
    """`import anakin_tpu_torch` needs neither grpc nor msgpack."""
    code = ("import sys, anakin_tpu_torch, anakin_tpu_torch.runtime; "
            "bad = [m for m in ('grpc', 'msgpack') if m in sys.modules]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
