"""Standalone model server, the port of `anakin_tpu/serving/server.py`.

`python -m anakin_tpu_torch.serving.server --model-dir DIR --name NAME
--port P [--device cpu]`

Loads a saved model directory (`model_io.load_model`), builds the bucketed
continuous batcher, and serves the gRPC AnakinService until SIGTERM or
SIGINT: the per-process server the daemon supervises (reference: the
per-device server processes forked by `framework/service/
service_daemon.cpp`).  It runs on CUDA unless `--device` says otherwise,
and exits with an error where there is no card.

On SIGTERM the exit is bounded: gRPC's stop (in-flight RPCs get the
reference's 2 s to drain), then the service's threads, each waited for
only until its deadline (`EXIT_STEPS_S`, 4.5 s in all, well inside the
daemon's `TERM_WAIT_S`), then the process ends with `os._exit`,
without the interpreter's teardown (torch's and gRPC's threads there took
seconds on a loaded CPU, and nothing in this process needs it: every
reply has been sent and the output is flushed).  The exit prints each
step's seconds.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time

__all__ = ["with_batch", "make_net_factory", "main", "EXIT_STEPS_S"]

# the deadline of each step of the exit after SIGTERM, in seconds; gRPC's
# stop gives in-flight RPCs GRPC_GRACE_S to finish, as the reference does
EXIT_STEPS_S = {"grpc": 3.0, "service": 1.5}
GRPC_GRACE_S = 2.0


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
                    help="collective/compute overlap of the tensor-parallel "
                         "Nets built after it (parallel.overlap)")
    args = ap.parse_args(argv)

    if args.overlap:
        from ..parallel.overlap import enable_collective_overlap

        enable_collective_overlap(args.overlap)

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
    exit_bounded(server, svc)


def exit_bounded(server, svc, log=print) -> None:
    """Stop `server` and `svc`, each step within its `EXIT_STEPS_S`
    deadline, print the seconds each took, and end the process (code 0)."""
    t0 = time.monotonic()
    server.stop(grace=GRPC_GRACE_S).wait(timeout=EXIT_STEPS_S["grpc"])
    t1 = time.monotonic()
    svc.shutdown(timeout=EXIT_STEPS_S["service"])
    t2 = time.monotonic()
    log(f"anakin_tpu_torch server: exit in {t2 - t0:.3f} s (grpc "
        f"{t1 - t0:.3f} s, service {t2 - t1:.3f} s)", flush=True)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
