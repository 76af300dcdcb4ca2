"""The RNN nets, the port of `anakin_tpu/models/lstm_lm.py` (numpy only:
the graphs equal the JAX package's node for node and byte for byte): an LSTM
language model, a BiLSTM text classifier and a BiGRU-CRF tagger over dense
padded [B, T] token batches with a `lengths` edge.  Once quantized, each net
has one int8 dense, its output projection, which runs on `matmul_int8`.
"""

from __future__ import annotations

import numpy as np

from ..graph.ir import Graph, GraphBuilder

__all__ = ["build_lstm_lm", "build_text_classifier", "build_ner_tagger"]


def _rng_param(b, rng, shape, scale, hint):
    return b.param(rng.normal(0.0, scale, shape).astype(np.float32), hint)


def build_lstm_lm(batch: int = 4, seq_len: int = 32, vocab: int = 10000,
                  embed: int = 256, hidden: int = 512, layers: int = 2,
                  seed: int = 0) -> Graph:
    """LSTM language model: embed -> L x LSTM -> dense(vocab) -> softmax
    (reference benchmark `benchmark/RNN/` language model)."""
    b = GraphBuilder("lstm_lm")
    rng = np.random.default_rng(seed)
    ids = b.input((batch, seq_len), dtype="int32", name="input")
    lengths = b.input((batch,), dtype="int32", name="lengths")
    table = _rng_param(b, rng, (vocab, embed), 0.1, "embed")
    y = b.op("embedding", [ids, table])
    d = embed
    for i in range(layers):
        w_ih = _rng_param(b, rng, (d, 4 * hidden), 0.08, "w_ih")
        w_hh = _rng_param(b, rng, (hidden, 4 * hidden), 0.08, "w_hh")
        bias = _rng_param(b, rng, (4 * hidden,), 0.01, "b")
        y = b.op("lstm", [y, w_ih, w_hh, bias, lengths], has_bias=True,
                 has_lengths=True)
        d = hidden
    w_out = _rng_param(b, rng, (hidden, vocab), 0.05, "w_out")
    y = b.op("dense", [y, w_out], axis=2)
    y = b.op("softmax", [y], axis=-1)
    b.output(y)
    return b.finish()


def build_text_classifier(batch: int = 4, seq_len: int = 64, vocab: int = 5000,
                          embed: int = 128, hidden: int = 128,
                          num_classes: int = 2, seed: int = 0) -> Graph:
    """BiLSTM + seq-pool text classifier (reference
    `benchmark/RNN/` text_classification)."""
    b = GraphBuilder("text_classifier")
    rng = np.random.default_rng(seed)
    ids = b.input((batch, seq_len), dtype="int32", name="input")
    lengths = b.input((batch,), dtype="int32", name="lengths")
    table = _rng_param(b, rng, (vocab, embed), 0.1, "embed")
    x = b.op("embedding", [ids, table])
    outs = []
    for rev in (False, True):
        w_ih = _rng_param(b, rng, (embed, 4 * hidden), 0.08, "w_ih")
        w_hh = _rng_param(b, rng, (hidden, 4 * hidden), 0.08, "w_hh")
        bias = _rng_param(b, rng, (4 * hidden,), 0.01, "b")
        outs.append(b.op("lstm", [x, w_ih, w_hh, bias, lengths], has_bias=True,
                         has_lengths=True, reverse=rev))
    y = b.op("sequence_concat", outs)
    y = b.op("sequence_pool", [y, lengths], mode="max")
    w = _rng_param(b, rng, (2 * hidden, num_classes), 0.05, "w_cls")
    bias = _rng_param(b, rng, (num_classes,), 0.01, "b_cls")
    y = b.op("dense", [y, w, bias], has_bias=True)
    y = b.op("softmax", [y], axis=-1)
    b.output(y)
    return b.finish()


def build_ner_tagger(batch: int = 4, seq_len: int = 48, vocab: int = 8000,
                     embed: int = 128, hidden: int = 256, num_tags: int = 9,
                     seed: int = 0) -> Graph:
    """BiGRU + CRF decode tagger (reference `benchmark/RNN/` chinese_ner,
    `net_exec_test_language`/`sequence_labeling` workloads)."""
    b = GraphBuilder("ner_tagger")
    rng = np.random.default_rng(seed)
    ids = b.input((batch, seq_len), dtype="int32", name="input")
    lengths = b.input((batch,), dtype="int32", name="lengths")
    table = _rng_param(b, rng, (vocab, embed), 0.1, "embed")
    x = b.op("embedding", [ids, table])
    outs = []
    for rev in (False, True):
        w_ih = _rng_param(b, rng, (embed, 3 * hidden), 0.08, "w_ih")
        w_hh = _rng_param(b, rng, (hidden, 3 * hidden), 0.08, "w_hh")
        bias = _rng_param(b, rng, (3 * hidden,), 0.01, "b")
        outs.append(b.op("gru", [x, w_ih, w_hh, bias, lengths], has_bias=True,
                         has_lengths=True, reverse=rev))
    y = b.op("sequence_concat", outs)
    w = _rng_param(b, rng, (2 * hidden, num_tags), 0.05, "w_emit")
    emission = b.op("dense", [y, w], axis=2)
    trans = _rng_param(b, rng, (num_tags + 2, num_tags), 0.1, "crf_w")
    tags = b.op("crf_decoding", [emission, trans, lengths])
    b.output(tags)
    return b.finish()
