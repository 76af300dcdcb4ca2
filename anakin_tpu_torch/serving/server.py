"""Standalone model server, the port of `anakin_tpu/serving/server.py`.

`python -m anakin_tpu_torch.serving.server --model-dir DIR --name NAME
--port P [--device cpu]`

Loads a saved model directory (`model_io.load_model`), builds the bucketed
continuous batcher, and serves the gRPC AnakinService until SIGTERM or
SIGINT: the per-process server the daemon supervises (reference: the
per-device server processes forked by `framework/service/
service_daemon.cpp`).  It runs on CUDA unless `--device` says otherwise,
and exits with an error where there is no card.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

__all__ = ["with_batch", "make_net_factory", "main"]


def with_batch(graph, batch: int):
    """A clone of `graph` with its inputs' batch dimension set to `batch`."""
    g = graph.clone()
    for name in g.inputs:
        shape, dt = g.input_specs[name]
        g.input_specs[name] = ((batch,) + tuple(shape[1:]), dt)
    return g


def make_net_factory(graph, precision: str = "bf16", device=None,
                     log=print):
    """`factory(batch) -> Net` of `with_batch(graph, batch)`, one `Net` a
    bucket.  `precision`: "fp32", "bf16", or "auto", which applies
    `quant.apply_precision_policy` per batch (int8 where the graph and batch
    profit, else bf16) and logs each choice.  A graph quantized upstream
    runs on the int8 kernels at any of them.

    "int8" is refused here, before any net is built: the JAX server offers
    it, but no `Net` takes it, and its batcher then hangs (ROADMAP §3 item
    23)."""
    from ..quant import apply_precision_policy
    from ..runtime.net import Net

    if precision not in ("fp32", "bf16", "auto"):
        raise ValueError(
            f"--precision {precision!r}: serve fp32, bf16 or auto.  For int8, "
            "serve the model directory the converter wrote with its "
            "quantization (its int8 nodes run on the int8 kernels at bf16); "
            "the JAX server's 'int8' is a fault no Net accepts (ROADMAP §3 "
            "item 23)")

    def factory(batch: int) -> Net:
        g = with_batch(graph, batch)
        if precision == "auto":
            g, chosen = apply_precision_policy(g, batch, graph.scales or None)
            log(f"precision policy: batch {batch} -> {chosen}")
            return Net(g, precision="bf16", device=device)
        return Net(g, precision=precision, device=device)

    return factory


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--name", default="model")
    ap.add_argument("--port", type=int, default=50051)
    ap.add_argument("--precision", default="bf16",
                    help='"fp32" | "bf16" | "auto": auto applies the '
                         "per-(model, batch) policy (quant/policy.py): int8 "
                         "when the graph and batch profit, bf16 otherwise; a "
                         "quantized directory runs on the int8 kernels at "
                         "any of them")
    ap.add_argument("--buckets", default="1,2,4,8")
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default CUDA; cpu to serve on the "
                         "CPU)")
    ap.add_argument("--overlap", default=None, choices=("default", "aggressive"),
                    help="collective/compute overlap for multi-device "
                         "serving: not yet in this package")
    args = ap.parse_args(argv)

    if args.overlap:
        raise NotImplementedError(
            "--overlap: multi-device serving waits for the port's "
            "parallelism slice (ROADMAP module 9)")

    from ..model_io import load_model
    from . import AnakinService, ContinuousBatcher, serve

    graph = load_model(args.model_dir)
    factory = make_net_factory(graph, args.precision, args.device,
                               log=lambda m: print(m, flush=True))
    svc = AnakinService(device=args.device)  # raises where there is no card
    batcher = ContinuousBatcher(
        factory, list(graph.inputs),
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        max_delay_ms=args.max_delay_ms)
    svc.initial(args.name, batcher)
    server = serve(svc, port=args.port)
    print(f"anakin_tpu_torch server: model {args.name!r} on port "
          f"{server._bound_port}", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    # wait for grpc's shutdown before exiting: an unwaited stop races its
    # threads against interpreter teardown
    server.stop(grace=2).wait(timeout=15)
    svc.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
