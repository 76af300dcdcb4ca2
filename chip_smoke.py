"""Smoke run of anakin_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives the port's main path, ResNet-50 int8 inference at 224 px and batch
128 (the JAX package's `bench.py` configuration, with its checked-in scale
table and random weights from seed 0), in four phases:

  1. build    compile every kernel of the path from `anakin_tpu_torch/csrc`
              (one nvcc per source, all at once) and print what ptxas says;
  2. path     one forward through `Net.prediction` with every kernel's launch
              count set to 0 just before and read just after: matmul_int8
              must launch 40 times and conv3x3_int8 13 times; the softmax
              must be finite rows summing to 1; then ms/step and img/s from
              CUDA events, and one profiled step (device time by kernel);
  3. kernels  each kernel's wrapper against its plain PyTorch version on the
              card, on random int8 data at every distinct shape and epilogue
              the path gave it: int8 outputs must be equal, float outputs
              within rtol 1e-6 (the same float32 operations in the same
              order; the plain version's exact float64 accumulator).  Each is
              timed with CUDA events beside its plain version, its bound and,
              for the GEMM, `torch._int_mm` on the same operands (PyTorch
              has no int8 convolution on CUDA, so the 3x3 has none);
  4. cpu/gpu  the same network at batch 2 on the card and on the CPU (the
              plain versions): equal top-1 and softmax within rtol 5e-3 and
              atol 1e-4.  The int8 edges and logits are reported, not held
              to a bound: the stem's float conv sums in another order on each
              device, and a rounding it moves propagates.

Prints the card's name and power limit, a `{"kernels": [...]}` line, and as
its last line `{"ok": true, "device": {...}}`.  Any failed check raises and
the script exits non-zero; so does a machine without a GPU.  Details go to
`build/chip_smoke.json` as well.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_INT8_OPS = 1979e12     # H100 SXM dense int8 tensor-core rate, op/s
PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes/s
BATCH, IMAGE = 128, 224
SCALES = os.path.join(ROOT, "artifacts", "resnet50_seed0_scales.txt")
KERNEL_META = {
    "matmul_int8": ("anakin_tpu_torch/csrc/matmul_int8.cu",
                    "anakin_tpu/kernels/matmul_int8.py:95"),
    "conv3x3_int8": ("anakin_tpu_torch/csrc/conv3x3_int8.cu",
                     "anakin_tpu/kernels/conv_int8.py:118"),
}


def log(*a):
    print(*a, flush=True)


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2, windows: int = 5) -> float:
    """Milliseconds of one `fn()` on the card, from CUDA events: the median
    over `windows` windows of the mean over `iters` calls, so that one
    slow window does not set the number."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def build_graph(batch: int):
    from anakin_tpu_torch import optimize
    from anakin_tpu_torch.models import build_resnet50
    from anakin_tpu_torch.quant import quantize_graph, read_scale_table

    g = optimize(build_resnet50(batch=batch, image_size=IMAGE))
    return quantize_graph(g, read_scale_table(SCALES))


def kernel_calls(graph, shapes):
    """The kernel calls one forward makes: [(kernel, config)], where a
    config holds the GEMM or conv shape and the epilogue, read off the
    graph's int8 nodes and the edge shapes of a run."""
    from anakin_tpu_torch.ops.quantized import conv_kind

    calls = []
    for node in graph.nodes.values():
        if node.op not in ("conv2d_int8", "dense_int8"):
            continue
        w = graph.params[node.inputs[1]]
        out = shapes[node.outputs[0]]
        epi = dict(activation=node.attr("activation"),
                   bias=bool(node.attr("has_bias")),
                   residual=bool(node.attr("has_residual")),
                   requant=node.attr("out_scale") is not None)
        if (node.op == "conv2d_int8" and conv_kind(node) == "conv3x3"
                and w.shape[:2] == (3, 3)):
            n, h, w_, o = out
            calls.append(("conv3x3_int8", dict(N=n, H=h, W=w_, C=w.shape[2],
                                               O=o, **epi)))
        else:
            k = int(np.prod(w.shape[:-1]))
            calls.append(("matmul_int8", dict(M=int(np.prod(out[:-1])), K=k,
                                              N=w.shape[-1], **epi)))
    return calls


def bound(kernel, cfg):
    """(bound_ms, "bytes" or "operations"): the larger of the bytes the
    function must move (inputs read once, output written once) over HBM
    bandwidth and its operations over the int8 tensor-core peak."""
    if kernel == "conv3x3_int8":
        m, k, n = cfg["N"] * cfg["H"] * cfg["W"], 9 * cfg["C"], cfg["O"]
        a_bytes = m * cfg["C"]
    else:
        m, k, n = cfg["M"], cfg["K"], cfg["N"]
        a_bytes = m * k
    nbytes = (a_bytes + k * n + 4 * n * (2 if cfg["bias"] else 1)
              + m * n * (1 if cfg["residual"] else 0)
              + m * n * (1 if cfg["requant"] else 4))
    ops = 2 * m * n * k
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_INT8_OPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_kernel(kernel, cfg, gen):
    """Wrapper against plain version on the card; times of both and of
    the library's product.  Returns a result dict."""
    from anakin_tpu_torch.kernels.conv_int8 import (conv3x3_int8,
                                                    conv3x3_int8_plain)
    from anakin_tpu_torch.kernels.matmul_int8 import (matmul_int8,
                                                      matmul_int8_plain)

    dev = torch.device("cuda")

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    if kernel == "conv3x3_int8":
        rows = (cfg["N"], cfg["H"], cfg["W"])
        a, b, n_out = i8(*rows, cfg["C"]), i8(3, 3, cfg["C"], cfg["O"]), cfg["O"]
        fn, plain = conv3x3_int8, conv3x3_int8_plain
    else:
        rows = (cfg["M"],)
        a, b, n_out = i8(cfg["M"], cfg["K"]), i8(cfg["K"], cfg["N"]), cfg["N"]
        fn, plain = matmul_int8, matmul_int8_plain
    ws = torch.rand(n_out, generator=gen, device=dev) * 0.009 + 0.001
    bias = (torch.randn(n_out, generator=gen, device=dev) if cfg["bias"]
            else None)
    res = i8(*rows, n_out) if cfg["residual"] else None
    kw = dict(in_scale=0.05, activation=cfg["activation"],
              out_scale=0.4 if cfg["requant"] else None,
              residual_scale=0.07 if cfg["residual"] else None)
    launches = fn.launches
    got = fn(a, b, ws, bias, res, **kw)
    want = plain(a, b, ws, bias, res, **kw)
    torch.cuda.synchronize()
    if got.dtype == torch.int8:
        err = float((got.int() - want.int()).abs().max())
        ok = err == 0
    else:
        d = (got.float() - want.float()).abs()
        err = float(d.max())
        ok = bool((d <= 1e-6 * want.float().abs()).all())
    ms = cuda_ms(lambda: fn(a, b, ws, bias, res, **kw), iters=20)
    plain_ms = cuda_ms(lambda: plain(a, b, ws, bias, res, **kw), iters=3,
                       warmup=1)
    fn.launches = launches  # the comparison's launches are not the path's
    library_ms = None
    if kernel == "matmul_int8":
        library_ms = cuda_ms(lambda: torch._int_mm(a, b), iters=20)
    bms, by = bound(kernel, cfg)
    return dict(kernel=kernel, **cfg, ok=ok, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
                bound_by=by)


def summarize(results, counts):
    """One entry per kernel for the `kernels` line: times and bounds summed
    over the calls one forward makes."""
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        rs = [r for r in results if r["kernel"] == name]

        def per_forward(key):
            return sum(r[key] * r["calls_per_forward"] for r in rs)

        by_ops = sum(r["bound_ms"] * r["calls_per_forward"] for r in rs
                     if r["bound_by"] == "operations")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name],
            max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=per_forward("ms"), plain_ms=per_forward("plain_ms"),
            bound_ms=per_forward("bound_ms"),
            bound_by=("operations" if 2 * by_ops >= per_forward("bound_ms")
                      else "bytes"),
            library_ms=(None if any(r["library_ms"] is None for r in rs)
                        else per_forward("library_ms"))))
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on a GPU")
        return 1
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.kernels import _build
    from anakin_tpu_torch.kernels.conv_int8 import conv3x3_int8
    from anakin_tpu_torch.kernels.matmul_int8 import matmul_int8
    from anakin_tpu_torch.runtime.net import build_forward

    card = gpu_name_and_power_limit()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} | {card}")
    report = {"card": card}

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    built = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    for name, (path, secs, out) in built.items():
        log(f"[build] {name}: {secs:.1f} s -> {os.path.relpath(path, ROOT)}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")

    # ----------------------------------------------------------- 2. path
    t0 = time.perf_counter()
    g128 = build_graph(BATCH)
    net = ak.Net(g128, precision="bf16")          # device: CUDA by default
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(BATCH, IMAGE, IMAGE, 3)).astype(np.float32)).cuda()
    out_edge = g128.outputs[0]
    net.prediction({"input": x})                  # warm-up
    torch.cuda.synchronize()
    log(f"[path] graph, weights and first forward: "
        f"{time.perf_counter() - t0:.1f} s")

    matmul_int8.launches = 0
    conv3x3_int8.launches = 0
    y = net.prediction({"input": x})[out_edge]
    torch.cuda.synchronize()
    counts = {"matmul_int8": matmul_int8.launches,
              "conv3x3_int8": conv3x3_int8.launches}
    log(f"[path] launches in one forward: {counts}")
    if counts != {"matmul_int8": 40, "conv3x3_int8": 13}:
        raise AssertionError(f"expected 40 + 13 kernel launches, got {counts}")
    yf = y.float()
    if tuple(y.shape) != (BATCH, 1000) or not torch.isfinite(yf).all():
        raise AssertionError(f"bad output {tuple(y.shape)}")
    if (yf.sum(-1) - 1).abs().max() > 2e-2:  # bf16 softmax rows
        raise AssertionError("softmax rows do not sum to 1")

    step_ms = cuda_ms(lambda: net.prediction({"input": x}), iters=10)
    report["path"] = dict(batch=BATCH, image=IMAGE, precision="bf16",
                          launches=counts, ms_per_step=step_ms,
                          img_per_s=BATCH / step_ms * 1e3)
    log(f"[path] ResNet-50 int8 b{BATCH} {IMAGE}px: {step_ms:.3f} ms/step, "
        f"{BATCH / step_ms * 1e3:.1f} img/s | {card}")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.prediction({"input": x})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():  # kernels only: host ops are not device time
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            by_name[ev.key] = (ev.self_device_time_total / 1e3, ev.count)
    busy_ms = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    report["profile"] = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                             top=[(k, t, c) for k, (t, c) in top])
    if busy_ms > 0:
        log(f"[profile] one step: wall {wall_ms:.2f} ms under the profiler, "
            f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}% of "
            f"it, {100 * busy_ms / step_ms:.1f}% of the unprofiled step)")
        for k, (t, c) in top:
            log(f"[profile]   {t:9.3f} ms  x{c:<4d} {k[:90]}")
    else:
        log("[profile] the profiler recorded no device time: not measured")

    # -------------------------------------------------------- 3. kernels
    edges = [e for n in g128.nodes.values() for e in n.outputs]
    fwd, _ = build_forward(g128, "bf16", tap_edges=edges)
    with torch.inference_mode():
        shapes = {k: tuple(v.shape) for k, v in fwd(net.params, {"input": x}).items()}
    calls = kernel_calls(g128, shapes)
    distinct = {}
    for kernel, cfg in calls:
        key = (kernel, tuple(sorted(cfg.items(), key=lambda kv: kv[0])))
        distinct[key] = distinct.get(key, 0) + 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = []
    for (kernel, cfg_items), n_calls in distinct.items():
        r = check_kernel(kernel, dict(cfg_items), gen)
        r["calls_per_forward"] = n_calls
        results.append(r)
        shape = ("x".join(str(r[k]) for k in ("N", "H", "W", "C", "O"))
                 if kernel == "conv3x3_int8"
                 else "x".join(str(r[k]) for k in ("M", "K", "N")))
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"[kernel] {kernel:12s} {shape:22s} x{n_calls} act={r['activation']}"
            f" res={int(r['residual'])} int8out={int(r['requant'])} "
            f"err={r['max_abs_err']:g} ms={r['ms']:.4f} plain={r['plain_ms']:.3f}"
            f" lib={lib} bound={r['bound_ms']:.4f} ({r['bound_by']})")
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel differs from its plain version: {bad}")
    report["kernel_configs"] = results
    log("[kernel] conv3x3_int8 has no library_ms: PyTorch has no int8 "
        "convolution on CUDA")

    kernels = summarize(results, counts)

    # -------------------------------------------------------- 4. cpu/gpu
    g2 = build_graph(2)
    logits = next(n.outputs[0] for n in g2.nodes.values()
                  if n.op == "dense_int8")
    int8_edges = [n.outputs[0] for n in g2.nodes.values()
                  if n.op in ("conv2d_int8", "pool2d_int8")
                  or n.attr("quant_out_scale") is not None]
    taps = int8_edges + [logits]
    x2 = x[:2].cpu()
    y_gpu = ak.Net(g2, "bf16", tap_edges=taps).prediction({"input": x2})
    y_cpu = ak.Net(g2, "bf16", device="cpu", tap_edges=taps).prediction(
        {"input": x2})
    lsb = max(int((y_gpu[e].cpu().int() - y_cpu[e].int()).abs().max())
              for e in int8_edges)
    n_diff = sum(int((y_gpu[e].cpu() != y_cpu[e]).sum()) for e in int8_edges)
    lg, lc = y_gpu[logits].float().cpu(), y_cpu[logits].float()
    logit_err = float((lg - lc).abs().max() / lc.abs().max())
    sg, sc = y_gpu[out_edge].float().cpu(), y_cpu[out_edge].float()
    soft_err = float((sg - sc).abs().max())
    log(f"[cpu/gpu] b2: int8 edges max diff {lsb} LSB ({n_diff} elements "
        f"differ), logits max diff {logit_err:.3g} of the largest, softmax max "
        f"abs diff {soft_err:.3g}, top-1 gpu {sg.argmax(-1).tolist()} cpu "
        f"{sc.argmax(-1).tolist()}")
    if not torch.equal(sg.argmax(-1), sc.argmax(-1)):
        raise AssertionError("GPU and CPU runs disagree on top-1")
    torch.testing.assert_close(sg, sc, rtol=5e-3, atol=1e-4)
    report["cpu_gpu"] = dict(int8_max_lsb=lsb, int8_diff_elements=n_diff,
                             logits_rel_err=logit_err,
                             softmax_max_abs=soft_err)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(dict(report, kernels=kernels), f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
