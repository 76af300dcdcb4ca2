"""The plain references agree with the port's plain CPU path at small
sizes: the program in float32 gives the reference's numbers, so what a
cell's check reads on the card is the program's precision and nothing
else; the lower-precision controls read far above it."""

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.reference.decoder import Decoder, w4_dequant
from portbench.reference.resnet_int8 import ResNetInt8
from portbench.tests.tiny import TINY_DECODER

RESNET = dict(layers=[1, 1, 1, 1], widths=[64, 128, 256, 512], expansion=4,
              stem_kernel=7, num_classes=10, image_size=32, weight_seed=3)


@pytest.fixture(scope="module")
def resnet():
    from anakin_tpu_torch import Net, optimize
    from anakin_tpu_torch.models.resnet import build_resnet
    from anakin_tpu_torch.quant import quantize_graph
    from anakin_tpu_torch.quant.calibrator import calibrate

    g = build_resnet((1, 1, 1, 1), 2, 32, num_classes=10, seed=3,
                     name="resnet50")
    ws = inputs.resnet_weights(RESNET)
    for n, w in zip(g.params, ws):
        assert np.array_equal(g.params[n], w)   # the builder's recipe
    go = optimize(g)
    x = inputs.image_batches(5, 3, 2, 32, "cpu")
    table = calibrate(go, [{"input": xi.numpy()} for xi in x[:2]],
                      method="max", device="cpu")
    gq = quantize_graph(go, table)
    (soft,) = [n for n in gq.nodes.values() if n.op == "softmax"]
    out = {}
    for prec in ("fp32", "bf16"):
        net = Net(gq, precision=prec, device="cpu",
                  tap_edges=[soft.inputs[0]])
        out[prec] = net({"input": x[2]})[soft.inputs[0]].float()
    ref = {b: ResNetInt8(RESNET, ws, table, "cpu", weight_bits=b)(x[2])
           for b in (8, 4)}
    return out, ref


def _rel(a, b):
    return float(((a - b).norm(dim=1) / b.norm(dim=1)).max())


def test_resnet_reference_is_the_float32_program(resnet):
    out, ref = resnet
    assert _rel(out["fp32"], ref[8]) < 1e-5


def test_resnet_control_reads_far_above_the_bf16_program(resnet):
    out, ref = resnet
    assert _rel(ref[4], ref[8]) > 3 * _rel(out["bf16"], ref[8])


def test_w4_dequant_is_the_programs_packing():
    from anakin_tpu_torch.quant.quantize import _w4_group_quantize

    w = torch.randn(256, 48, generator=torch.Generator().manual_seed(0))
    packed, scale, G = _w4_group_quantize(w.numpy(), 128)
    p = torch.from_numpy(packed.astype(np.int16)).reshape(2, 64, 48)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    q = torch.cat([lo, hi], dim=1).to(torch.float32)
    want = (q * torch.from_numpy(scale)[:, None, :]).reshape(256, 48)
    assert torch.equal(w4_dequant(w, 128), want)


@pytest.fixture(scope="module")
def served():
    """Two requests served by the program's scheduler on the CPU, in
    float32 and in bf16, with the tiny decoder's weights."""
    from anakin_tpu_torch.models.transformer import TransformerConfig
    from anakin_tpu_torch.runtime.decode_scheduler import DecodeScheduler

    c = dict(TINY_DECODER, rms_norm_eps=1e-6, rope_theta=10000.0,
             kv_cache_dtype="int8", kv_scale=0.05, weight_only="w4",
             w4_group=128)
    tc = TransformerConfig(vocab=512, embed=256, heads=2, kv_heads=1,
                           layers=2, mlp_mult=2, max_seq=256, norm="rms",
                           mlp="swiglu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (20, 70)]
    out = {}
    for prec in ("fp32", "bf16"):
        s = DecodeScheduler(tc, batch=2, params=inputs.decoder_weights_numpy(
            c, 9, "cpu"), precision=prec, kv_cache_dtype="int8",
            kv_scale=0.05, weight_only="w4", fuse_window=4, device="cpu")
        futs = [s.submit(p, 12) for p in prompts]
        out[prec] = [f.result(timeout=120)[len(p):]
                     for f, p in zip(futs, prompts)]
        s.close()
    w = inputs.decoder_weights(c, 9, "cpu")
    return prompts, out, Decoder(c, w), Decoder(c, w, act_bits=8)


def _gap(ref, prompt, toks, pick=None):
    seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]))
    want = ref.logits(seq, len(prompt))
    chosen = (torch.as_tensor(toks.astype(np.int64)) if pick is None
              else pick.logits(seq, len(prompt)).argmax(1))
    return float((want.max(1).values
                  - want.gather(1, chosen[:, None])[:, 0]).max())


def test_decoder_reference_serves_the_float32_programs_tokens(served):
    prompts, out, ref, _ = served
    for p, t in zip(prompts, out["fp32"]):
        assert _gap(ref, p, t) < 1e-4
        seq = torch.as_tensor(np.concatenate([p, t[:-1]]))
        assert torch.equal(ref.logits(seq, len(p)).argmax(1),
                           torch.as_tensor(t.astype(np.int64)))


def test_decoder_control_reads_above_the_bf16_program(served):
    prompts, out, ref, low = served
    prog = max(_gap(ref, p, t) for p, t in zip(prompts, out["bf16"]))
    ctl = max(_gap(ref, p, t, low) for p, t in zip(prompts, out["bf16"]))
    assert ctl > 3 * prog, (ctl, prog)
