"""Smoke run of anakin_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives the port's three main paths through the entry points a user calls:
ResNet-50 int8 inference at 224 px and batch 128 (the JAX package's
`bench.py` configuration, with its checked-in scale table and random weights
from seed 0), 1B-class LLM serving (vocab 32000, E 2048, 16 layers, 16
heads over 8 kv heads, max_seq 2048: the JAX package's `llm1b_*`
configuration, random weights from seed 0, built once for both LLM paths),
and MobileNet v1/v2 int8 inference at 224 px and batch 128 (the JAX
package's suite configuration: random weights from seed 0, scales from
`calibrate(method="max")` over two b1 batches from default_rng(0), a bf16
net).  Phases:

  1. build    compile every kernel from `anakin_tpu_torch/csrc` (one nvcc
              per source, all at once) and print what ptxas says;
  2. resnet   one forward through `Net.prediction` with every kernel's
              launch count set to 0 just before and read just after:
              matmul_int8 must launch 40 times and conv3x3_int8 13 times;
              the softmax must be finite rows summing to 1; then ms/step
              and img/s from CUDA events, and one profiled step;
  3. kernels  each ResNet kernel's wrapper against its plain PyTorch version
              on the card, on random int8 data at every distinct shape and
              epilogue of the path: int8 outputs equal, float outputs within
              rtol 1e-6; timed beside the plain version, the bound and, for
              the GEMM, `torch._int_mm` (PyTorch has no int8 convolution on
              CUDA, so the 3x3 has none);
  4. cpu/gpu  ResNet at batch 2 on the card and on the CPU: equal top-1 and
              softmax within rtol 5e-3 and atol 1e-4;
  5. llm A    `GenerationSession(batch 8, bf16, int8 KV cache)` generates 32
              greedy tokens after a 512-token prompt: the prefill (bucket
              512, so flash) must launch flash_attention 16 times; tokens in
              range, logits finite; prefill ms, decode ms per token step and
              tokens/s from CUDA events; one profiled decode step;
  6. llm B    the w4 decode step (`weight_only_quantize(bits=4)` of the
              int8-KV aligned decode graph) through `Net(precision="bf16")`
              for 32 chained greedy steps: 33 matmul_w4 launches a step;
              ms per token step, tokens/s, one profiled step;
  7. kernels  flash_attention and matmul_w4 against their plain versions on
              the card at every distinct shape of paths A and B, plus a
              ragged S = 300 with segment ids, S = 2048, ragged and
              prefill-sized M, and float32 inputs; tolerances as each
              kernel's source states them; each timed beside its plain
              version, its bound and a library call
              (`scaled_dot_product_attention`, `torch._weight_int4pack_mm`);
  8. cpu/gpu  the LLM at full width and 2 layers, batch 2, 512-token prompt,
              on the card (flash prefill) and on the CPU (dense prefill):
              last-position logits and one teacher-forced w4 decode step
              within 1.5% of the largest logit, greedy tokens equal wherever
              the CPU's top-2 gap exceeds that;
  9. mobilenet for v1, then v2: `calibrate` on the card, `quantize_graph`,
              `Net(precision="bf16")`, one b128 forward with the counts set
              to 0 just before and read just after: depthwise3x3_int8 must
              launch 13 / 17 times, matmul_int8 14 / 35, conv3x3_int8
              never; softmax rows finite and summing to 1; ms/step and
              img/s from CUDA events, one profiled step;
 10. kernel   depthwise3x3_int8 against its plain version at every distinct
              shape of the two forwards (9 + 10) with the path's epilogue,
              plus a ragged C, odd H/W, float32 and bf16 outputs,
              leaky_relu, no bias and a misaligned x: int8 outputs equal,
              float outputs within rtol 1e-6; timed by CUDA-graph replay
              with x rotated out of L2, beside its bound, its plain version
              and, as context only, cuDNN's bf16 grouped conv;
 11. cpu/gpu  v1 and v2 at b2 from one graph: `calibrate` scales on the
              card and the CPU within rtol 1e-4; the int8 net on both, node
              by node on the CPU's inputs (int8 kernel outputs equal, the
              fp32 stem's requant within 1 LSB, float outputs within 8e-3),
              whole from the CPU's int8 stem output (int8 edges equal,
              softmax within rtol 5e-3 / atol 1e-4), and whole from the
              image (top-1 equal wherever the CPU's top-2 gap exceeds twice
              that tolerance: the fp32 stem conv may round an element the
              other way on the two devices, and random weights amplify it).

Prints the card's name and power limit, a `{"kernels": [...]}` line, and as
its last line `{"ok": true, "device": {...}}`.  Any failed check raises and
the script exits non-zero; so does a machine without a GPU.  Details go to
`build/chip_smoke.json` as well.
"""

import itertools
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
PEAK_BF16_OPS = 989e12      # H100 SXM dense bf16 tensor-core rate, flop/s
PEAK_F32_OPS = 67e12        # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes/s
BATCH, IMAGE = 128, 224
SCALES = os.path.join(ROOT, "artifacts", "resnet50_seed0_scales.txt")
KERNEL_META = {
    "matmul_int8": ("anakin_tpu_torch/csrc/matmul_int8.cu",
                    "anakin_tpu/kernels/matmul_int8.py:95"),
    "conv3x3_int8": ("anakin_tpu_torch/csrc/conv3x3_int8.cu",
                     "anakin_tpu/kernels/conv_int8.py:118"),
    "flash_attention": ("anakin_tpu_torch/csrc/flash_attention.cu",
                        "anakin_tpu/kernels/flash_attention.py:101"),
    "matmul_w4": ("anakin_tpu_torch/csrc/matmul_w4.cu",
                  "anakin_tpu/kernels/matmul_w4.py:129"),
    "depthwise3x3_int8": ("anakin_tpu_torch/csrc/depthwise3x3_int8.cu",
                          "anakin_tpu/kernels/depthwise_int8.py:171"),
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


def graph_ms(fn, iters: int = 20, windows: int = 5) -> float:
    """Device milliseconds of one `fn()`: `iters` calls captured in one CUDA
    graph, the replay timed with CUDA events (median of `windows`).  A call
    of a few tens of microseconds spends longer than that in Python, so
    events around an eager loop of them would time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def rotating(fn, args_list):
    """`fn` over a cycle of argument tuples: each call finds its operands
    out of the 50 MB L2, as a decode step finds its weights."""
    it = itertools.cycle(args_list)
    return lambda: fn(*next(it))


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
        if node.op == "conv2d_int8" and conv_kind(node) == "dw3x3":
            n, h, w_, c = shapes[node.inputs[0]]
            out_kind = ("int8" if epi["requant"]
                        else node.attr("out_dtype", "float32"))
            calls.append(("depthwise3x3_int8", dict(
                N=n, H=h, W=w_, C=c, stride=int(node.attr("strides")[0]),
                activation=epi["activation"], bias=epi["bias"],
                out=out_kind)))
        elif (node.op == "conv2d_int8" and conv_kind(node) == "conv3x3"
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


def summarize(results, counts, units):
    """One entry per kernel for the `kernels` line: times and bounds summed
    over the calls of one main-path run (`units[name]` says which run; the
    launches are that run's count).  Rows checked at shapes the path does
    not give (calls_per_run 0) count for max_abs_err only."""
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        rs = [r for r in results if r["kernel"] == name]
        path = [r for r in rs if r["calls_per_run"]]

        def per_run(key):
            return sum(r[key] * r["calls_per_run"] for r in path)

        by_ops = sum(r["bound_ms"] * r["calls_per_run"] for r in path
                     if r["bound_by"] == "operations")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name], unit=units[name],
            max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=per_run("ms"), plain_ms=per_run("plain_ms"),
            bound_ms=per_run("bound_ms"),
            bound_by=("operations" if 2 * by_ops >= per_run("bound_ms")
                      else "bytes"),
            library_ms=(None if any(r["library_ms"] is None for r in path)
                        else per_run("library_ms"))))
    return kernels


def kernel_wrappers():
    from anakin_tpu_torch.kernels import (conv3x3_int8, depthwise3x3_int8,
                                          flash_attention, matmul_int8,
                                          matmul_w4)

    return {"matmul_int8": matmul_int8, "conv3x3_int8": conv3x3_int8,
            "flash_attention": flash_attention, "matmul_w4": matmul_w4,
            "depthwise3x3_int8": depthwise3x3_int8}


def reset_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def no_launches():
    return {name: 0 for name in kernel_wrappers()}


def profile_step(fn, step_ms, tag):
    """Device time by kernel in one `fn()` under torch.profiler, and the
    share of the unprofiled step the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():  # kernels only: host ops are not device time
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            by_name[ev.key] = (ev.self_device_time_total / 1e3, ev.count)
    busy_ms = sum(t for t, _ in by_name.values())
    launches = sum(c for _, c in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    if busy_ms > 0:
        log(f"[{tag}] profiled step: wall {wall_ms:.2f} ms under the profiler, "
            f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of "
            f"it, {100 * busy_ms / step_ms:.1f}% of the unprofiled step) in "
            f"{launches} kernel launches")
        for k, (t, c) in top:
            log(f"[{tag}]   {t:9.3f} ms  x{c:<4d} {k[:90]}")
    else:
        log(f"[{tag}] the profiler recorded no device time: not measured")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                busy_share_of_step=busy_ms / step_ms, kernel_launches=launches,
                top=[(k, t, c) for k, (t, c) in top])


# ------------------------------------------------------------------ ResNet

def resnet_phases(report, card):
    """Phases 2-4.  Returns the kernel check rows and the path's counts."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.runtime.net import build_forward

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

    reset_counts()
    y = net.prediction({"input": x})[out_edge]
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[path] launches in one forward: {counts}")
    if counts != dict(no_launches(), matmul_int8=40, conv3x3_int8=13):
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
    report["profile"] = profile_step(lambda: net.prediction({"input": x}),
                                     step_ms, "profile")

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
        r["calls_per_run"] = n_calls
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
    return results, counts


# --------------------------------------------------------------------- LLM

LLM_CFG = dict(vocab=32000, embed=2048, heads=16, kv_heads=8, layers=16,
               max_seq=2048)
LLM_BATCH, PROMPT, NEW = 8, 512, 32
# card vs CPU logits, as a fraction of the largest |logit|: about three
# times the 0.4-0.5% measured on an H100 (PERF.md section 6)
LLM_TOL = 0.015


def llm_path_a(report, cfg, params, card):
    """Phase 5: GenerationSession, 512-token prompt, 32 greedy tokens."""
    from anakin_tpu_torch.runtime.generate import GenerationSession

    t0 = time.perf_counter()
    sess = GenerationSession(cfg, batch=LLM_BATCH, params=params,
                             precision="bf16", kv_cache_dtype="int8",
                             device="cuda")
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab, (LLM_BATCH, PROMPT)).astype(np.int32)
    sess.generate(prompt, NEW)                    # warm-up
    torch.cuda.synchronize()
    log(f"[llm A] session, weights and first generate: "
        f"{time.perf_counter() - t0:.1f} s")

    reset_counts()
    t0 = time.perf_counter()
    tokens = sess.generate(prompt, NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = read_counts()
    log(f"[llm A] launches in one generate (1 prefill + {NEW} steps): {counts}")
    if counts != dict(no_launches(), flash_attention=cfg.layers):
        raise AssertionError(f"expected {cfg.layers} flash_attention launches "
                             f"in the prefill, got {counts}")
    new = tokens[:, PROMPT:]
    if tokens.shape != (LLM_BATCH, PROMPT + NEW) or new.min() < 0 \
            or new.max() >= cfg.vocab:
        raise AssertionError(f"bad tokens {tokens.shape} {new.min()} {new.max()}")

    prompt_t = torch.from_numpy(prompt).cuda()
    logits, caches = sess._prefill(prompt_t)
    tok = torch.argmax(logits[:, 0, :], -1).to(torch.int32)
    step_logits, _ = sess._step(tok, PROMPT, caches)
    for name, lg in (("prefill", logits), ("decode", step_logits)):
        if tuple(lg.shape) != (LLM_BATCH, 1, cfg.vocab) or \
                not torch.isfinite(lg.float()).all():
            raise AssertionError(f"bad {name} logits {tuple(lg.shape)}")
    if not torch.equal(tok.cpu(), torch.from_numpy(tokens[:, PROMPT])):
        raise AssertionError("first token differs between two generate runs")
    prefill_ms = cuda_ms(lambda: sess._prefill(prompt_t), iters=3, warmup=1)
    step_ms = cuda_ms(lambda: sess._step(tok, PROMPT, caches), iters=10)
    res = dict(batch=LLM_BATCH, prompt=PROMPT, new_tokens=NEW,
               precision="bf16", kv_cache="int8", launches=counts,
               prefill_ms=prefill_ms, decode_ms_per_step=step_ms,
               decode_tokens_per_s=LLM_BATCH / step_ms * 1e3,
               generate_wall_s=gen_s)
    log(f"[llm A] prefill {PROMPT} tokens x{LLM_BATCH}: {prefill_ms:.3f} ms; "
        f"decode {step_ms:.3f} ms/token step, "
        f"{LLM_BATCH / step_ms * 1e3:.1f} tokens/s; generate wall "
        f"{gen_s:.3f} s | {card}")
    res["profile_decode"] = profile_step(
        lambda: sess._step(tok, PROMPT, caches), step_ms, "llm A")
    res["profile_prefill"] = profile_step(
        lambda: sess._prefill(prompt_t), prefill_ms, "llm A prefill")
    report["llm_a"] = res
    return counts


def llm_path_b(report, cfg, params, card):
    """Phase 6: the w4 decode step, 32 chained greedy steps."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.models import build_transformer_decode_step
    from anakin_tpu_torch.quant import weight_only_quantize

    t0 = time.perf_counter()
    g = weight_only_quantize(build_transformer_decode_step(
        cfg, LLM_BATCH, params, kv_cache_dtype="int8", aligned_pos=True), bits=4)
    n_w4 = sum(n.op == "dense_w4" for n in g.nodes.values())
    if n_w4 != 2 * cfg.layers + 1:
        raise AssertionError(f"expected {2 * cfg.layers + 1} dense_w4 nodes, "
                             f"got {n_w4}")
    net = ak.Net(g, precision="bf16", device="cuda")
    logits_e = g.outputs[0]
    cache_edges = [(f"cache_{kv}_{i}", g.nodes[f"dec_att_{i}"].outputs[1 + j])
                   for i in range(cfg.layers) for j, kv in enumerate("kv")]
    shape = (LLM_BATCH, cfg.kv_heads, cfg.max_seq, cfg.head_dim)
    caches0 = {k: torch.zeros(shape, dtype=torch.int8, device="cuda")
               for k, _ in cache_edges}

    def run(steps):
        caches, tok = dict(caches0), torch.zeros(
            (LLM_BATCH, 1), dtype=torch.int32, device="cuda")
        for t in range(steps):
            out = net.prediction(dict(caches, input=tok, pos=torch.full(
                (LLM_BATCH,), t, dtype=torch.int32, device="cuda")))
            tok = torch.argmax(out[logits_e][:, 0, :], -1).to(torch.int32)[:, None]
            caches = {k: out[e] for k, e in cache_edges}
        return tok, out[logits_e]

    run(2)                                        # warm-up
    torch.cuda.synchronize()
    log(f"[llm B] w4 graph, weights and warm-up: {time.perf_counter() - t0:.1f} s")
    reset_counts()
    tok, logits = run(NEW)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[llm B] launches in {NEW} decode steps: {counts}")
    if counts != dict(no_launches(), matmul_w4=n_w4 * NEW):
        raise AssertionError(f"expected {n_w4} matmul_w4 launches a step, "
                             f"got {counts}")
    if not torch.isfinite(logits.float()).all() or tok.min() < 0 \
            or tok.max() >= cfg.vocab:
        raise AssertionError("bad w4 decode output")
    step_ms = cuda_ms(lambda: run(NEW), iters=1, warmup=0, windows=3) / NEW
    res = dict(batch=LLM_BATCH, steps=NEW, precision="bf16", kv_cache="int8",
               dense_w4_nodes=n_w4, launches=counts, ms_per_step=step_ms,
               tokens_per_s=LLM_BATCH / step_ms * 1e3)
    log(f"[llm B] w4 decode b{LLM_BATCH}: {step_ms:.3f} ms/token step, "
        f"{LLM_BATCH / step_ms * 1e3:.1f} tokens/s | {card}")
    feed = dict(caches0, input=tok, pos=torch.full(
        (LLM_BATCH,), NEW, dtype=torch.int32, device="cuda"))
    res["profile"] = profile_step(lambda: net.prediction(feed), step_ms, "llm B")
    report["llm_b"] = res
    return counts


def _flash_bound(q, k, n_pairs, segs):
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    if segs is not None:
        nbytes += 4 * (segs.numel() * 2)
    ops = 4 * q.shape[1] * q.shape[3] * n_pairs
    peak = PEAK_BF16_OPS if q.dtype == torch.bfloat16 else PEAK_F32_OPS
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
    return (t_o, "operations") if t_o >= t_b else (t_b, "bytes")


def check_flash(B, H, Hkv, S, D, dtype, causal, lengths, gen, calls):
    """flash_attention against mha_reference on the card; tolerance as in
    csrc/flash_attention.cu: float32 |d| <= 3e-5 max|v|; bf16 |d| <=
    2^-7 |want| + 3e-5 max|v|."""
    import torch.nn.functional as F
    from anakin_tpu_torch.kernels.flash_attention import (flash_attention,
                                                          mha_reference)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v = rnd(B, H, S, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    t = torch.arange(S, device="cuda")
    segs = None
    allowed = torch.ones((B, S, S), dtype=torch.bool, device="cuda")
    if lengths is not None:
        segs = (t[None] >= torch.tensor(lengths, device="cuda")[:, None]).to(torch.int32)
        allowed &= segs[:, :, None] == segs[:, None, :]
    if causal:
        allowed &= (t[None, :] <= t[:, None])[None]
    n_pairs = int(allowed.sum())
    launches = flash_attention.launches
    got = flash_attention(q, k, v, segs, segs, causal=causal)
    want = mha_reference(q, k, v, segs, segs, causal=causal)
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs()
    vmax = float(v.float().abs().max())
    tol = 3e-5 * vmax + (2.0 ** -7 * want.float().abs() if dtype == torch.bfloat16
                         else 0.0)
    ok = bool((d <= tol).all())
    iters = 20 if S <= 512 else 5
    ms = graph_ms(lambda: flash_attention(q, k, v, segs, segs, causal=causal),
                  iters=iters)
    plain_ms = graph_ms(lambda: mha_reference(q, k, v, segs, segs,
                                              causal=causal), iters=2)
    flash_attention.launches = launches
    kr = torch.repeat_interleave(k, H // Hkv, dim=1)
    vr = torch.repeat_interleave(v, H // Hkv, dim=1)
    if lengths is None:
        lib = lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=causal)
    else:
        mask = allowed[:, None]
        lib = lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask)
    library_ms = graph_ms(lib, iters=iters)
    bms, by = _flash_bound(q, k, n_pairs, segs)
    return dict(kernel="flash_attention", shape=[B, H, Hkv, S, D],
                dtype=str(dtype).split(".")[-1], causal=causal,
                lengths=lengths, ok=ok, max_abs_err=float(d.max()),
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bms, bound_by=by, calls_per_run=calls)


def _int4pack_yardstick(x, packed, scales, group):
    """(weights, scales-and-zeros, output) of `torch._weight_int4pack_mm`
    on the same weights repacked to its layout (unsigned nibbles q + 8,
    even k in the high nibble, zero point 0), or the reason it cannot be
    called."""
    from anakin_tpu_torch.kernels.matmul_w4 import unpack_w4

    if x.dtype != torch.bfloat16:
        return None, "takes bf16 x only on CUDA"
    try:
        q = unpack_w4(packed, torch.ones_like(scales), group, torch.float32)
        qu = (q.to(torch.int32) + 8).t().contiguous()            # [N, K]
        w_u8 = ((qu[:, ::2] << 4) | qu[:, 1::2]).to(torch.uint8)
        wp = torch._convert_weight_to_int4pack(w_u8, 8)
        sz = torch.stack([scales.to(torch.bfloat16),
                          torch.zeros_like(scales, dtype=torch.bfloat16)],
                         dim=-1).contiguous()
        return (wp, sz, torch._weight_int4pack_mm(x, wp, group, sz)), None
    except Exception as e:  # the yardstick only; the port never calls it
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def check_w4(M, K, N, G, dtype, gen, calls):
    """matmul_w4 against matmul_w4_plain on the card.  Tolerance: the two
    sum the same float32 products in another order, and any order is
    within K * 2^-24 * (|x| @ |W|) of the exact sum, so |d| <= 2 K 2^-24
    (|x| @ |W|)."""
    from anakin_tpu_torch.kernels.matmul_w4 import (matmul_w4, matmul_w4_plain,
                                                    unpack_w4)
    from anakin_tpu_torch.quant.quantize import _w4_group_quantize

    rng = np.random.default_rng(M * 7 + K + N)
    p_np, s_np, g = _w4_group_quantize(
        rng.normal(0.0, K ** -0.5, (K, N)).astype(np.float32), G)
    packed, scales = torch.from_numpy(p_np).cuda(), torch.from_numpy(s_np).cuda()
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    launches = matmul_w4.launches
    got = matmul_w4(x, packed, scales, group=g)
    want = matmul_w4_plain(x, packed, scales, group=g)
    w = unpack_w4(packed, scales, g, dtype)
    mag = x.float().abs() @ w.float().abs()
    d = (got - want).abs()
    ok = bool((d <= 2 * K * 2.0 ** -24 * mag).all())
    # enough copies of the weights that every call reads them from HBM
    n_copies = max(1, -(-100 * 2 ** 20 // (packed.numel() + 4 * scales.numel())))
    copies = [(x, packed.clone(), scales.clone()) for _ in range(n_copies)]
    ms = graph_ms(rotating(lambda *a: matmul_w4(*a, group=g), copies),
                  iters=2 * n_copies)
    plain_ms = graph_ms(rotating(lambda *a: matmul_w4_plain(*a, group=g),
                                 copies), iters=n_copies)
    matmul_w4.launches = launches
    lib, why = _int4pack_yardstick(x, packed, scales, g)
    library_ms = lib_err = None
    if lib is not None:
        wp, sz, lib_out = lib
        lib_err = float((lib_out.float() - want).abs().max() / want.abs().max())
        if lib_err > 2e-2:
            why = f"disagrees with the function (rel err {lib_err:.3g})"
        else:
            library_ms = graph_ms(rotating(
                lambda w_, s_: torch._weight_int4pack_mm(x, w_, g, s_),
                [(wp.clone(), sz.clone()) for _ in range(n_copies)]),
                iters=2 * n_copies)
    dequant_mm_ms = graph_ms(rotating(torch.matmul, [(x, w.clone())
                                                     for _ in range(n_copies)]),
                             iters=2 * n_copies)
    xb = x.element_size()
    nbytes = K // 2 * N + (K // g) * N * 4 + M * K * xb + M * N * 4
    ops = 2 * M * N * K
    peak = PEAK_BF16_OPS if dtype == torch.bfloat16 else PEAK_F32_OPS
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
    bms, by = (t_o, "operations") if t_o >= t_b else (t_b, "bytes")
    return dict(kernel="matmul_w4", shape=[M, K, N, g],
                dtype=str(dtype).split(".")[-1], ok=ok,
                max_abs_err=float(d.max()), max_rel_to_mag=float((d / mag).max()),
                ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, library_rel_err=lib_err, library_none_reason=why,
                dequant_bf16_matmul_ms=dequant_mm_ms, bound_ms=bms, bound_by=by,
                calls_per_run=calls)


def llm_kernels(report, cfg):
    """Phase 7: both LLM kernels against their plain versions."""
    E, F_ = cfg.embed, 4 * cfg.embed
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    B, H, Hkv, D = LLM_BATCH, cfg.heads, cfg.kv_heads, cfg.head_dim
    flash_cases = [  # (B, H, Hkv, S, dtype, causal, lengths, calls per generate)
        (B, H, Hkv, PROMPT, torch.bfloat16, True, None, cfg.layers),
        (2, H, Hkv, 300, torch.bfloat16, True, [300, 173], 0),
        (2, H, Hkv, 300, torch.float32, True, [300, 173], 0),
        (B, H, Hkv, PROMPT, torch.float32, True, None, 0),
        (B, H, Hkv, 2048, torch.bfloat16, True, None, 0),
    ]
    w4_cases = [  # (M, K, N, dtype, calls per 32 steps)
        (B, E, F_, torch.bfloat16, cfg.layers * NEW),
        (B, F_, E, torch.bfloat16, cfg.layers * NEW),
        (B, E, cfg.vocab, torch.bfloat16, NEW),
        (5, E, F_, torch.bfloat16, 0),
        (4096, E, F_, torch.bfloat16, 0),
        (B, F_, E, torch.float32, 0),
        (5, E, F_, torch.float32, 0),
        (4096, E, F_, torch.float32, 0),
    ]
    results = []
    for b, h, hkv, s, dt, causal, lens, calls in flash_cases:
        r = check_flash(b, h, hkv, s, D, dt, causal, lens, gen, calls)
        results.append(r)
        log(f"[kernel] flash_attention {r['shape']} {r['dtype']} causal={causal}"
            f" lengths={lens} x{calls} err={r['max_abs_err']:.3g} ok={r['ok']} "
            f"ms={r['ms']:.4f} plain={r['plain_ms']:.3f} "
            f"sdpa={r['library_ms']:.4f} bound={r['bound_ms']:.4f} ({r['bound_by']})")
    for m, k, n, dt, calls in w4_cases:
        r = check_w4(m, k, n, 128, dt, gen, calls)
        results.append(r)
        lib = ("none: " + r["library_none_reason"] if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        log(f"[kernel] matmul_w4 {m}x{k}->{n} {r['dtype']} x{calls} "
            f"err={r['max_abs_err']:.3g} ({r['max_rel_to_mag']:.2g} of |x|@|W|) "
            f"ok={r['ok']} ms={r['ms']:.4f} plain={r['plain_ms']:.3f} "
            f"int4pack_mm={lib} dequantized-bf16-matmul="
            f"{r['dequant_bf16_matmul_ms']:.4f} bound={r['bound_ms']:.4f} "
            f"({r['bound_by']})")
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel differs from its plain version: {bad}")
    report["llm_kernel_configs"] = results
    return results


def llm_cpu_gpu(report, cfg_full):
    """Phase 8: full width, 2 layers, batch 2, 512-token prompt, on the
    card (flash prefill, kernels) and on the CPU (dense prefill, plain
    versions)."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.models import (TransformerConfig,
                                         build_transformer_decode_step,
                                         make_transformer_params)
    from anakin_tpu_torch.quant import weight_only_quantize
    from anakin_tpu_torch.runtime.generate import GenerationSession

    cfg = TransformerConfig(**dict(LLM_CFG, layers=2))
    params = make_transformer_params(cfg, 1)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, (2, PROMPT))
    kw = dict(batch=2, params=params, precision="bf16", kv_cache_dtype="int8")
    sg = GenerationSession(cfg, device="cuda", **kw)
    sc = GenerationSession(cfg, device="cpu", **kw)
    if sg._attention_impl(PROMPT) != "flash" or sc._attention_impl(PROMPT):
        raise AssertionError("the card should take flash and the CPU dense")
    reset_counts()
    lg, _ = sg._prefill(torch.from_numpy(prompt).cuda())
    torch.cuda.synchronize()
    if read_counts()["flash_attention"] != cfg.layers:
        raise AssertionError("the card's prefill did not run flash_attention")
    lc, caches = sc._prefill(torch.from_numpy(prompt))

    g4 = weight_only_quantize(build_transformer_decode_step(
        cfg, 2, params, kv_cache_dtype="int8", aligned_pos=True), bits=4)
    tok = torch.argmax(lc[:, 0].float(), -1).to(torch.int32)[:, None]
    feed = dict(caches, input=tok, pos=torch.full((2,), PROMPT, dtype=torch.int32))
    reset_counts()
    dg = ak.Net(g4, "bf16", device="cuda").prediction(
        {k: v.clone().cuda() for k, v in feed.items()})[g4.outputs[0]]
    torch.cuda.synchronize()
    if read_counts()["matmul_w4"] != 2 * cfg.layers + 1:
        raise AssertionError("the card's w4 step did not run matmul_w4")
    dc = ak.Net(g4, "bf16", device="cpu").prediction(
        {k: v.clone() for k, v in feed.items()})[g4.outputs[0]]

    res = {}
    for name, g_, c_ in (("prefill", lg, lc), ("w4_step", dg, dc)):
        gf, cf = g_[:, 0].float().cpu(), c_[:, 0].float()
        scale = float(cf.abs().max())
        err = float((gf - cf).abs().max())
        top2 = torch.topk(cf, 2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        same = gf.argmax(-1) == cf.argmax(-1)
        decided = gap > LLM_TOL * scale
        log(f"[cpu/gpu llm] {name}: logits max diff {err:.4g} "
            f"({err / scale:.3g} of the largest, tolerance {LLM_TOL}), greedy "
            f"tokens gpu {gf.argmax(-1).tolist()} cpu {cf.argmax(-1).tolist()}, "
            f"top-2 gap {gap.tolist()}")
        if err > LLM_TOL * scale:
            raise AssertionError(f"{name}: GPU and CPU logits differ by {err}")
        if not bool(same[decided].all()):
            raise AssertionError(f"{name}: greedy tokens differ where decided")
        res[name] = dict(max_abs_diff=err, rel_to_max=err / scale,
                         tokens_equal=same.tolist(), top2_gap=gap.tolist())
    report["llm_cpu_gpu"] = res


# --------------------------------------------------------------- MobileNet

# routed int8 nodes per forward: depthwise3x3_int8, matmul_int8
MOBILENETS = {"mobilenet_v1": (13, 14), "mobilenet_v2": (17, 35)}
# card vs CPU softmax, as the ResNet phase holds it
SOFT_RTOL, SOFT_ATOL = 5e-3, 1e-4


def mobilenet_builder(name):
    from anakin_tpu_torch import models

    return getattr(models, "build_" + name)


def mobilenet_scales(name, device=None):
    """The JAX package's suite recipe: `calibrate(method="max")` of the
    optimized b1 graph over two b1 batches from default_rng(0)."""
    from anakin_tpu_torch import optimize
    from anakin_tpu_torch.quant import calibrate

    rng = np.random.default_rng(0)
    cal = [{"input": rng.normal(size=(1, IMAGE, IMAGE, 3)).astype(np.float32)}
           for _ in range(2)]
    g1 = optimize(mobilenet_builder(name)(batch=1, image_size=IMAGE))
    return calibrate(g1, cal, method="max", device=device)


def mobilenet_path(name, report, card):
    """Phase 9 for one model: calibrate on the card, quantize, one b128
    forward with the counts read around it, ms/step, a profiled step.
    Returns the launch counts and the forward's depthwise calls."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.quant import quantize_graph
    from anakin_tpu_torch.runtime.net import build_forward

    n_dw, n_mm = MOBILENETS[name]
    t0 = time.perf_counter()
    scales = mobilenet_scales(name)                # on the card
    t_cal = time.perf_counter() - t0
    g = quantize_graph(ak.optimize(mobilenet_builder(name)(
        batch=BATCH, image_size=IMAGE)), scales)
    net = ak.Net(g, precision="bf16")              # device: CUDA by default
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(BATCH, IMAGE, IMAGE, 3)).astype(np.float32)).cuda()
    out_edge = g.outputs[0]
    net.prediction({"input": x})                   # warm-up
    torch.cuda.synchronize()
    log(f"[{name}] calibrate on the card {t_cal:.1f} s; graph, weights and "
        f"first forward {time.perf_counter() - t0:.1f} s")

    reset_counts()
    y = net.prediction({"input": x})[out_edge]
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[{name}] launches in one forward: {counts}")
    if counts != dict(no_launches(), depthwise3x3_int8=n_dw, matmul_int8=n_mm):
        raise AssertionError(f"expected {n_dw} depthwise3x3_int8 and {n_mm} "
                             f"matmul_int8 launches, got {counts}")
    yf = y.float()
    if tuple(y.shape) != (BATCH, 1000) or not torch.isfinite(yf).all():
        raise AssertionError(f"bad output {tuple(y.shape)}")
    if (yf.sum(-1) - 1).abs().max() > 2e-2:  # bf16 softmax rows
        raise AssertionError("softmax rows do not sum to 1")

    step_ms = cuda_ms(lambda: net.prediction({"input": x}), iters=10)
    res = dict(batch=BATCH, image=IMAGE, precision="bf16",
               calibrate_s=t_cal, launches=counts, ms_per_step=step_ms,
               img_per_s=BATCH / step_ms * 1e3)
    log(f"[{name}] int8 b{BATCH} {IMAGE}px: {step_ms:.3f} ms/step, "
        f"{BATCH / step_ms * 1e3:.1f} img/s | {card}")
    res["profile"] = profile_step(lambda: net.prediction({"input": x}),
                                  step_ms, name)
    report[name] = res

    edges = [e for n in g.nodes.values() for e in n.outputs]
    fwd, _ = build_forward(g, "bf16", tap_edges=edges)
    with torch.inference_mode():
        shapes = {k: tuple(v.shape)
                  for k, v in fwd(net.params, {"input": x}).items()}
    calls = [cfg for kernel, cfg in kernel_calls(g, shapes)
             if kernel == "depthwise3x3_int8"]
    return counts, calls


def _dw_bound(cfg):
    n, h, w, c, s = (cfg[k] for k in ("N", "H", "W", "C", "stride"))
    out_elems = n * ((h - 1) // s + 1) * ((w - 1) // s + 1) * c
    out_bytes = {"int8": 1, "float32": 4, "bfloat16": 2}[cfg["out"]]
    nbytes = (n * h * w * c + 9 * c + 4 * c * (2 if cfg["bias"] else 1)
              + out_elems * out_bytes)
    ops = 2 * 9 * out_elems
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_INT8_OPS * 1e3
    return (t_o, "operations") if t_o >= t_b else (t_b, "bytes")


def check_dw(cfg, gen, misaligned=False):
    """depthwise3x3_int8 against its plain version on the card: int8
    outputs equal, float outputs within rtol 1e-6.  Times from CUDA-graph
    replay with x rotated through >= 100 MB of copies, beside the bound,
    the plain version and, as context only, cuDNN's bf16 grouped conv on
    the same shapes (not the same function: PyTorch has no int8 depthwise
    conv on CUDA)."""
    import torch.nn.functional as F
    from anakin_tpu_torch.kernels.depthwise_int8 import (
        depthwise3x3_int8, depthwise3x3_int8_plain)

    def place(t):
        """t itself, or a contiguous copy 1 byte off 16-byte alignment
        (the kernel's narrow path)."""
        if not misaligned:
            return t.clone()
        buf = torch.empty(t.numel() + 1, dtype=torch.int8, device="cuda")
        return buf[1:].view(t.shape).copy_(t)

    n, h, w_, c, s = (cfg[k] for k in ("N", "H", "W", "C", "stride"))
    x = place(torch.randint(-127, 128, (n, h, w_, c), generator=gen,
                            device="cuda", dtype=torch.int8))
    w = torch.randint(-127, 128, (3, 3, 1, c), generator=gen, device="cuda",
                      dtype=torch.int8)
    ws = torch.rand(c, generator=gen, device="cuda") * 0.009 + 0.001
    bias = torch.randn(c, generator=gen, device="cuda") if cfg["bias"] else None
    kw = dict(stride=s, in_scale=0.05, activation=cfg["activation"],
              act_alpha=0.1,
              out_scale=0.4 if cfg["out"] == "int8" else None,
              out_dtype=getattr(torch, "float32" if cfg["out"] == "int8"
                                else cfg["out"]))
    launches = depthwise3x3_int8.launches
    got = depthwise3x3_int8(x, w, ws, bias, **kw)
    want = depthwise3x3_int8_plain(x, w, ws, bias, **kw)
    torch.cuda.synchronize()
    if got.dtype == torch.int8:
        err = float((got.int() - want.int()).abs().max())
        ok = err == 0
    else:
        d = (got.float() - want.float()).abs()
        err = float(d.max())
        ok = bool((d <= 1e-6 * want.float().abs()).all())
    n_copies = max(2, -(-100 * 2 ** 20 // x.numel()))
    copies = [(place(x),) for _ in range(n_copies)]
    iters = n_copies * -(-20 // n_copies)
    ms = graph_ms(rotating(lambda x_: depthwise3x3_int8(x_, w, ws, bias, **kw),
                           copies), iters=iters)
    plain_ms = graph_ms(rotating(lambda x_: depthwise3x3_int8_plain(
        x_, w, ws, bias, **kw), copies[:2]), iters=2)
    depthwise3x3_int8.launches = launches
    wb = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()   # [C, 1, 3, 3]
    try:
        bf = [(x_.to(torch.bfloat16).permute(0, 3, 1, 2),) for (x_,) in copies]
        cudnn_ms = graph_ms(rotating(lambda x_: F.conv2d(
            x_, wb, stride=s, padding=1, groups=c), bf), iters=iters)
        del bf
    except Exception as e:  # context only; the port never calls it
        cudnn_ms = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    bms, by = _dw_bound(cfg)
    return dict(kernel="depthwise3x3_int8", **cfg, misaligned=misaligned,
                ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=None, cudnn_bf16_grouped_conv_ms=cudnn_ms,
                bound_ms=bms, bound_by=by)


# extra depthwise cases the path does not give: ragged C, odd H/W at s1,
# float outputs, leaky_relu, no bias, a misaligned x
DW_EXTRA = [
    (dict(N=8, H=56, W=56, C=40, stride=1, activation="relu6", bias=True,
          out="int8"), False),
    (dict(N=8, H=57, W=55, C=64, stride=1, activation="relu", bias=True,
          out="int8"), False),
    (dict(N=32, H=56, W=56, C=128, stride=1, activation="relu6", bias=True,
          out="float32"), False),
    (dict(N=32, H=28, W=28, C=256, stride=2, activation="relu6", bias=True,
          out="bfloat16"), False),
    (dict(N=16, H=28, W=28, C=256, stride=1, activation="leaky_relu",
          bias=True, out="int8"), False),
    (dict(N=16, H=14, W=14, C=512, stride=2, activation=None, bias=False,
          out="int8"), False),
    (dict(N=16, H=28, W=28, C=128, stride=1, activation="relu6", bias=True,
          out="int8"), True),
]


def dw_kernels(report, path_calls):
    """Phase 10: depthwise3x3_int8 at every distinct shape of the two
    forwards and at the extra cases.  `path_calls[name]` lists one
    forward's calls."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    per_model = {name: {} for name in path_calls}
    for name, calls in path_calls.items():
        for cfg in calls:
            key = tuple(sorted(cfg.items(), key=lambda kv: kv[0]))
            per_model[name][key] = per_model[name].get(key, 0) + 1
    distinct = list(dict.fromkeys(k for m in per_model.values() for k in m))
    cases = [(dict(k), False) for k in distinct] + DW_EXTRA
    results = []
    for cfg, misaligned in cases:
        key = tuple(sorted(cfg.items(), key=lambda kv: kv[0]))
        r = check_dw(cfg, gen, misaligned)
        r["calls"] = {name: per_model[name].get(key, 0) for name in per_model}
        r["calls_per_run"] = sum(r["calls"].values())
        results.append(r)
        cud = r["cudnn_bf16_grouped_conv_ms"]
        cud = f"{cud:.4f}" if isinstance(cud, float) else cud
        log(f"[kernel] depthwise3x3_int8 {r['N']}x{r['H']}x{r['W']}x{r['C']} "
            f"s{r['stride']} act={r['activation']} bias={int(r['bias'])} "
            f"out={r['out']}{' misaligned' if misaligned else ''} "
            f"x{r['calls']} err={r['max_abs_err']:g} ms={r['ms']:.4f} "
            f"plain={r['plain_ms']:.3f} bound={r['bound_ms']:.4f} "
            f"({r['bound_by']}) lib=none cudnn-bf16-grouped-conv={cud}")
    for name in per_model:
        rows = [r for r in results if r["calls"][name]]

        def total(key, rows=rows, name=name):
            return sum(r[key] * r["calls"][name] for r in rows)

        log(f"[kernel] depthwise3x3_int8 per {name} forward: "
            f"{sum(r['calls'][name] for r in rows)} calls, ms={total('ms'):.4f} "
            f"bound={total('bound_ms'):.4f} plain={total('plain_ms'):.3f}")
        report.setdefault(name, {})["dw_kernel_ms"] = total("ms")
        report[name]["dw_bound_ms"] = total("bound_ms")
        report[name]["dw_plain_ms"] = total("plain_ms")
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel differs from its plain version: {bad}")
    report["dw_kernel_configs"] = results
    log("[kernel] depthwise3x3_int8 has no library_ms: PyTorch has no int8 "
        "depthwise convolution on CUDA (cuDNN's bf16 time is context only)")
    return results


def _node_by_node(gq, x, taps_cpu):
    """Each node of `gq` on the card and on the CPU, both fed the CPU
    net's values of its inputs: (largest LSB difference of an int8 output
    made by an int8 kernel, of any other int8 output, largest relative
    difference of a float output)."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.graph.ir import topological_order
    from anakin_tpu_torch.runtime.net import build_forward

    params = {dev: ak.Net(gq, "bf16", device=dev).params
              for dev in ("cuda", "cpu")}
    kernel_lsb = other_lsb = 0
    float_rel = 0.0
    for node in topological_order(gq):
        fwd, _ = build_forward(gq, "bf16", start_from=node.name,
                               stop_at=node.name)
        feed = {e: taps_cpu[e] for e in node.inputs if e in taps_cpu}
        if "input" in node.inputs:
            feed["input"] = torch.from_numpy(x)
        with torch.inference_mode():
            a = fwd(params["cuda"], {k: v.cuda() for k, v in feed.items()})[
                node.outputs[0]].cpu()
            b = fwd(params["cpu"], feed)[node.outputs[0]]
        if b.dtype == torch.int8:
            d = int((a.int() - b.int()).abs().max())
            if node.op.endswith("_int8") and node.op != "pool2d_int8":
                kernel_lsb = max(kernel_lsb, d)
            else:
                other_lsb = max(other_lsb, d)
        else:
            d = ((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))
            float_rel = max(float_rel, float(d))
    return kernel_lsb, other_lsb, float_rel


def mobilenet_cpu_gpu(report):
    """Phase 11: v1 and v2 at b2, 224 px, from one graph.  `calibrate` on
    the card and on the CPU; then the int8 net (CPU scales) three ways:
    node by node on the CPU's inputs (kernel outputs equal), the whole net
    from the CPU's int8 stem output (softmax within tolerance), and the
    whole net from the image (the fp32 stem conv may round an element to
    the other side on the two devices, and random weights amplify that
    flip downstream: top-1 equal where decided)."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.graph.ir import topological_order
    from anakin_tpu_torch.quant import calibrate, quantize_graph

    x2 = np.random.default_rng(2).normal(
        size=(2, IMAGE, IMAGE, 3)).astype(np.float32)
    for name in MOBILENETS:
        g = ak.optimize(mobilenet_builder(name)(batch=2, image_size=IMAGE))
        s_gpu = calibrate(g, [{"input": x2}], method="max")
        s_cpu = calibrate(g, [{"input": x2}], method="max", device="cpu")
        if sorted(s_gpu) != sorted(s_cpu):
            raise AssertionError("card and CPU calibrate different edges")
        cal_err = max(abs(s_gpu[e] - s_cpu[e]) / s_cpu[e] for e in s_cpu)
        gq = quantize_graph(g, s_cpu)
        order = topological_order(gq)
        edges = [e for n in order for e in n.outputs]
        i8 = [n.outputs[0] for n in order
              if n.op in ("conv2d_int8", "pool2d_int8")
              or n.attr("quant_out_scale") is not None]
        out = gq.outputs[0]

        reset_counts()
        y_gpu = ak.Net(gq, "bf16", tap_edges=edges).prediction({"input": x2})
        torch.cuda.synchronize()
        if read_counts()["depthwise3x3_int8"] != MOBILENETS[name][0]:
            raise AssertionError(f"{name}: the card's b2 forward did not run "
                                 f"depthwise3x3_int8")
        y_cpu = ak.Net(gq, "bf16", device="cpu", tap_edges=edges).prediction(
            {"input": x2})
        i8 = [e for e in i8 if y_cpu[e].dtype == torch.int8]
        lsb = max(int((y_gpu[e].cpu().int() - y_cpu[e].int()).abs().max())
                  for e in i8)
        n_diff = sum(int((y_gpu[e].cpu() != y_cpu[e]).sum()) for e in i8)
        stem_diff = int((y_gpu[i8[0]].cpu() != y_cpu[i8[0]]).sum())
        sg, sc = y_gpu[out].float().cpu(), y_cpu[out].float()
        soft_err = float((sg - sc).abs().max())
        top2 = torch.topk(sc, 2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        # decided: the top-2 gap exceeds what the tolerance lets both move
        decided = gap > 2 * (SOFT_ATOL + SOFT_RTOL * top2[:, 0])
        same = sg.argmax(-1) == sc.argmax(-1)

        kernel_lsb, other_lsb, float_rel = _node_by_node(gq, x2, y_cpu)

        stem_out = i8[0]  # the fp32 stem's requantized output
        cut = next(i for i, n in enumerate(order) if stem_out in n.inputs)
        tail = [e for n in order[cut:] for e in n.outputs]
        feed = {stem_out: y_cpu[stem_out]}
        t_gpu = ak.Net(gq, "bf16", start_from=order[cut].name,
                       tap_edges=tail).prediction(feed)
        t_cpu = ak.Net(gq, "bf16", device="cpu", start_from=order[cut].name,
                       tap_edges=tail).prediction(feed)
        tail_lsb = max(int((t_gpu[e].cpu().int() - t_cpu[e].int()).abs().max())
                       for e in i8[1:])
        tg, tc = t_gpu[out].float().cpu(), t_cpu[out].float()
        tail_err = float((tg - tc).abs().max())

        log(f"[cpu/gpu {name}] b2: calibrate scales max rel diff {cal_err:.3g}"
            f" over {len(s_cpu)} edges")
        log(f"[cpu/gpu {name}] node by node on the CPU's inputs: int8 kernel "
            f"outputs max diff {kernel_lsb} LSB, other int8 outputs (the fp32 "
            f"stem's requant) {other_lsb} LSB, float outputs max rel diff "
            f"{float_rel:.3g}")
        log(f"[cpu/gpu {name}] from the CPU's int8 stem output: int8 edges "
            f"max diff {tail_lsb} LSB, softmax max abs diff {tail_err:.3g}")
        log(f"[cpu/gpu {name}] from the image: stem output {stem_diff} "
            f"elements differ; int8 edges max diff {lsb} LSB ({n_diff} "
            f"elements differ); softmax max abs diff {soft_err:.3g}; top-1 gpu "
            f"{sg.argmax(-1).tolist()} cpu {sc.argmax(-1).tolist()}, top-2 gap "
            f"{gap.tolist()}")
        if cal_err > 1e-4:
            raise AssertionError(f"{name}: card and CPU scales differ by "
                                 f"{cal_err}")
        if kernel_lsb or other_lsb > 1 or float_rel > 8e-3:
            raise AssertionError(f"{name}: a node differs between the card "
                                 f"and the CPU on the same inputs")
        if tail_lsb:
            raise AssertionError(f"{name}: int8 edges differ from the same "
                                 f"stem output")
        torch.testing.assert_close(tg, tc, rtol=SOFT_RTOL, atol=SOFT_ATOL)
        if not bool(same[decided].all()):
            raise AssertionError(f"{name}: top-1 differs where decided")
        report.setdefault(name, {})["cpu_gpu"] = dict(
            calibrate_max_rel=cal_err, node_kernel_max_lsb=kernel_lsb,
            node_other_max_lsb=other_lsb, node_float_max_rel=float_rel,
            from_stem_int8_max_lsb=tail_lsb, from_stem_softmax_max_abs=tail_err,
            from_image_stem_diff_elements=stem_diff, from_image_int8_max_lsb=lsb,
            from_image_int8_diff_elements=n_diff,
            from_image_softmax_max_abs=soft_err, top1_equal=same.tolist(),
            top2_gap=gap.tolist())


def mobilenet_phases(report, card):
    """Phases 9-11.  Returns the kernel check rows and the depthwise
    launches of one v1 and one v2 forward."""
    t0 = time.perf_counter()
    path_calls, dw_launches = {}, 0
    for name in MOBILENETS:
        counts, path_calls[name] = mobilenet_path(name, report, card)
        dw_launches += counts["depthwise3x3_int8"]
    log(f"[time] phase 9 took {time.perf_counter() - t0:.0f} s")
    t0 = time.perf_counter()
    results = dw_kernels(report, path_calls)
    log(f"[time] phase 10 took {time.perf_counter() - t0:.0f} s")
    t0 = time.perf_counter()
    mobilenet_cpu_gpu(report)
    log(f"[time] phase 11 took {time.perf_counter() - t0:.0f} s")
    return results, dw_launches


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on a GPU")
        return 1
    from anakin_tpu_torch.kernels import _build
    from anakin_tpu_torch.models import TransformerConfig, make_transformer_params

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_power_limit()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} | {card}")
    report = {"card": card}
    t_start = time.perf_counter()

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    built = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    for name, (path, secs, out) in built.items():
        log(f"[build] {name}: {secs:.1f} s -> {os.path.relpath(path, ROOT)}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build]   {line.strip()}")

    # ------------------------------------------------------- 2-4. ResNet
    results, counts = resnet_phases(report, card)
    units = {"matmul_int8": "one ResNet-50 forward",
             "conv3x3_int8": "one ResNet-50 forward"}
    log(f"[time] ResNet phases done at {time.perf_counter() - t_start:.0f} s")

    # --------------------------------------------------------- 5-8. LLM
    t0 = time.perf_counter()
    cfg = TransformerConfig(**LLM_CFG)
    params = make_transformer_params(cfg, 0)  # built once, shared by A and B
    log(f"[llm] 1B-class weights ({sum(v.size for v in params.values()) / 1e6:.1f}"
        f" M params, seed 0): {time.perf_counter() - t0:.1f} s")
    counts["flash_attention"] = llm_path_a(report, cfg, params, card)[
        "flash_attention"]
    counts["matmul_w4"] = llm_path_b(report, cfg, params, card)["matmul_w4"]
    del params
    units.update(flash_attention="one generate (its 512-token prefill)",
                 matmul_w4=f"{NEW} w4 decode steps")
    results += llm_kernels(report, cfg)
    llm_cpu_gpu(report, cfg)
    log(f"[time] LLM phases done at {time.perf_counter() - t_start:.0f} s")

    # ----------------------------------------------------- 9-11. MobileNet
    dw_results, counts["depthwise3x3_int8"] = mobilenet_phases(report, card)
    results += dw_results
    units["depthwise3x3_int8"] = "one MobileNet v1 and one v2 forward"
    log(f"[time] all phases done at {time.perf_counter() - t_start:.0f} s")

    kernels = summarize(results, counts, units)
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
