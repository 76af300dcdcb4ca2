"""RPC inference service over gRPC generic handlers, the port of
`anakin_tpu/serving/rpc.py`, with its wire format.

Parity with the reference's brpc service (`framework/service/
anakin_service.h:30-114`, schema `framework/service/api/service.proto:17-50`):

  RPCRequest  { model: str, request_id: int,
                inputs:  [{name, shape, dtype, data}] }
  RPCResponse { request_id, outputs: [{name, shape, dtype, data}],
                info: { duration_ms, device_status{...} } }

Frames are msgpack dicts (self-describing, no generated code), the same
bytes as the JAX package's, on the service `anakin.AnakinService` with the
methods Evaluate, Generate, GenerateStream and ListModels: a JAX client
talks to this server and this client to a JAX server.  A bf16 output
travels under the dtype name "bfloat16" (ml_dtypes).

The service holds {model name -> ContinuousBatcher} the way the reference
held {model name -> Worker}, {model name -> DecodeScheduler} for the
Generate methods, and attaches the DeviceMonitor's status to every
response.
"""

from __future__ import annotations

import queue
import time
from concurrent import futures
from typing import Any, Dict, Optional

import grpc
import msgpack
import numpy as np

from .batcher import ContinuousBatcher
from .monitor import DeviceMonitor

__all__ = ["AnakinService", "serve", "RpcClient"]

_SERVICE = "anakin.AnakinService"


def _pack_array(name: str, a: np.ndarray) -> Dict[str, Any]:
    return {"name": name, "shape": list(a.shape), "dtype": str(a.dtype),
            "data": a.tobytes()}


def _np_dtype(name: str) -> np.dtype:
    if name == "bfloat16":  # numpy knows the name only as ml_dtypes' type
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def _unpack_array(d: Dict[str, Any]) -> np.ndarray:
    return np.frombuffer(d["data"], dtype=_np_dtype(d["dtype"])).reshape(
        d["shape"])


class AnakinService:
    """Model registry + evaluate dispatch (reference `AnakinService`).
    Without a `monitor` it starts a `DeviceMonitor(device=device)`: CUDA
    by default, raising where there is none."""

    def __init__(self, monitor: Optional[DeviceMonitor] = None, device=None):
        self._models: Dict[str, ContinuousBatcher] = {}
        self._llms: Dict[str, Any] = {}
        self._monitor = monitor or DeviceMonitor(device=device).start()

    def initial(self, model_name: str, batcher: ContinuousBatcher) -> None:
        """Register a model (reference `initial(model_name, path, threads)`)."""
        self._models[model_name] = batcher

    def initial_llm(self, model_name: str, scheduler) -> None:
        """Register a `runtime.DecodeScheduler` for the Generate RPCs."""
        self._llms[model_name] = scheduler

    def _llm_submit(self, request: Dict[str, Any], on_token=None):
        model = request["model"]
        if model not in self._llms:
            raise KeyError(f"llm {model!r} not loaded")
        prompt = np.asarray(request["prompt"], np.int32)
        return self._llms[model].submit(
            prompt, int(request.get("max_new_tokens", 16)),
            temperature=float(request.get("temperature", 0.0)),
            top_k=int(request.get("top_k", 0)),
            top_p=float(request.get("top_p", 0.0)),
            stop_tokens=[int(t) for t in request.get("stop_tokens", ())],
            on_token=on_token)

    def _info(self, t0: float) -> Dict[str, Any]:
        return {"duration_ms": (time.perf_counter() - t0) * 1e3,
                "device_status": self._monitor.status().to_dict()}

    def generate(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Autoregressive generation over a registered DecodeScheduler:
        {model, request_id, prompt: [int], max_new_tokens[, temperature,
        top_k, top_p, stop_tokens]} -> {tokens}."""
        t0 = time.perf_counter()
        fut = self._llm_submit(request)
        tokens = fut.result(timeout=300)
        return {
            "request_id": request.get("request_id", 0),
            "tokens": [int(t) for t in tokens],
            "info": self._info(t0),
        }

    def generate_stream(self, request: Dict[str, Any]):
        """Streaming generation: yields {"token": id} frames as tokens
        decode (pushed from the scheduler thread through a queue), then a
        final {"done": True, "tokens": [...], "info": {...}} frame.  If
        the client goes away mid-stream (generator closed), the request
        is cancelled and its slot freed."""
        t0 = time.perf_counter()
        tokq: "queue.Queue" = queue.Queue()
        fut = self._llm_submit(request, on_token=tokq.put)
        try:
            while True:
                try:
                    yield {"token": int(tokq.get(timeout=0.05))}
                except queue.Empty:
                    if fut.done():
                        break
            while not tokq.empty():         # drain post-done stragglers
                yield {"token": int(tokq.get_nowait())}
            tokens = [] if fut.cancelled() else \
                [int(t) for t in fut.result(timeout=300)]
            yield {
                "done": True,
                "request_id": request.get("request_id", 0),
                "tokens": tokens,
                "info": self._info(t0),
            }
        finally:
            if not fut.done():
                fut.cancel()

    def evaluate(self, request: Dict[str, Any]) -> Dict[str, Any]:
        t0 = time.perf_counter()
        model = request["model"]
        if model not in self._models:
            raise KeyError(f"model {model!r} not loaded")
        feed = {d["name"]: _unpack_array(d) for d in request["inputs"]}
        out = self._models[model].submit(feed).result(timeout=120)
        return {
            "request_id": request.get("request_id", 0),
            "outputs": [_pack_array(k, np.asarray(v)) for k, v in out.items()],
            "info": self._info(t0),
        }

    def list_models(self) -> Dict[str, Any]:
        return {"models": sorted(self._models)}

    def shutdown(self, timeout: Optional[float] = None) -> None:
        """Stop every batcher, scheduler and the monitor.  `timeout`: the
        seconds all of it may take together (each waits for its thread
        only until that deadline); None leaves each its own default."""
        deadline = None if timeout is None else time.monotonic() + timeout

        def left(default):
            return default if deadline is None else max(
                0.0, deadline - time.monotonic())

        for b in self._models.values():
            b.shutdown(timeout=left(5.0))
        for s_ in self._llms.values():
            s_.close(timeout=left(60.0))
        self._monitor.stop(timeout=left(2.0))


def _handler(service: AnakinService) -> grpc.GenericRpcHandler:
    def unary(method):
        def call(request_bytes, context):
            req = msgpack.unpackb(request_bytes, raw=False)
            try:
                return msgpack.packb(method(req), use_bin_type=True)
            except KeyError as e:
                context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return call

    def list_models(request_bytes, context):
        return msgpack.packb(service.list_models(), use_bin_type=True)

    def generate_stream(request_bytes, context):
        req = msgpack.unpackb(request_bytes, raw=False)
        try:
            for frame in service.generate_stream(req):
                yield msgpack.packb(frame, use_bin_type=True)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))

    methods = {
        "Evaluate": grpc.unary_unary_rpc_method_handler(
            unary(service.evaluate)),
        "Generate": grpc.unary_unary_rpc_method_handler(
            unary(service.generate)),
        "GenerateStream": grpc.unary_stream_rpc_method_handler(
            generate_stream),
        "ListModels": grpc.unary_unary_rpc_method_handler(list_models),
    }
    return grpc.method_handlers_generic_handler(_SERVICE, methods)


def serve(service: AnakinService, port: int = 0,
          max_workers: int = 8) -> grpc.Server:
    """Start a gRPC server on 127.0.0.1; returns it (call .stop()).  port=0
    picks a free port, which `server._bound_port` holds."""
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((_handler(service),))
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    server.start()
    server._bound_port = bound
    return server


class RpcClient:
    def __init__(self, target: str):
        self._channel = grpc.insecure_channel(target)

        def method(kind, name):
            return kind(f"/{_SERVICE}/{name}",
                        request_serializer=lambda b: b,
                        response_deserializer=lambda b: b)

        self._evaluate = method(self._channel.unary_unary, "Evaluate")
        self._list = method(self._channel.unary_unary, "ListModels")
        self._generate = method(self._channel.unary_unary, "Generate")
        self._generate_stream = method(self._channel.unary_stream,
                                       "GenerateStream")

    def wait_ready(self, timeout: float) -> None:
        """Block until the channel connects (a server listens on the
        target), raising `grpc.FutureTimeoutError` after `timeout` s."""
        grpc.channel_ready_future(self._channel).result(timeout=timeout)

    def evaluate(self, model: str, inputs: Dict[str, np.ndarray],
                 request_id: int = 0) -> Dict[str, Any]:
        req = {
            "model": model,
            "request_id": request_id,
            "inputs": [_pack_array(k, np.asarray(v)) for k, v in inputs.items()],
        }
        resp = msgpack.unpackb(self._evaluate(msgpack.packb(req, use_bin_type=True)),
                               raw=False)
        resp["outputs"] = {d["name"]: _unpack_array(d) for d in resp["outputs"]}
        return resp

    @staticmethod
    def _gen_req(model, prompt, max_new_tokens, request_id, **kw):
        req = {"model": model, "request_id": request_id,
               "prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
               "max_new_tokens": max_new_tokens}
        for k in ("temperature", "top_k", "top_p", "stop_tokens"):
            if kw.get(k) is not None:
                req[k] = kw[k]
        return req

    def generate(self, model: str, prompt, max_new_tokens: int = 16,
                 request_id: int = 0, **sampling) -> Dict[str, Any]:
        req = self._gen_req(model, prompt, max_new_tokens, request_id,
                            **sampling)
        return msgpack.unpackb(
            self._generate(msgpack.packb(req, use_bin_type=True)), raw=False)

    def generate_stream(self, model: str, prompt, max_new_tokens: int = 16,
                        request_id: int = 0, **sampling):
        """Yields {"token": id} frames, then the final {"done": True,
        "tokens": [...], "info": {...}} frame.  Closing the iterator
        early cancels the request server-side."""
        req = self._gen_req(model, prompt, max_new_tokens, request_id,
                            **sampling)
        stream = self._generate_stream(msgpack.packb(req, use_bin_type=True))
        try:
            for frame in stream:
                yield msgpack.unpackb(frame, raw=False)
        finally:
            stream.cancel()

    def list_models(self):
        return msgpack.unpackb(self._list(msgpack.packb({})), raw=False)["models"]

    def close(self):
        self._channel.close()
