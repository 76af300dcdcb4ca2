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
net); then, on the same LLM weights and ResNet net, the distinct-position
w4 decode ladder on matmul_w4 v2 and ResNet-50's 12 identity blocks
through the fused bottleneck_int8, the decode scheduler serving requests
on the LLM weights through CUDA graphs, speculative decoding on the LLM
weights, the autotuned long-context prefill, VGG16, GoogLeNet and
ShuffleNet v1 at 224 px, the SSD300-VGG16, YOLOv3-tiny and Faster R-CNN
detectors at b1 and full width, the FCN-8s lite and ICNet lite
segmentation nets, the three RNN nets (the LSTM language model, the
BiLSTM text classifier, the BiGRU-CRF tagger), model IO: a ResNet-50
`torch.nn.Module` converted, quantized, saved, loaded, exported and run
as a loaded program, and serving: the LLM scheduler behind the Generate
RPCs, that ResNet-50 behind a batcher, a Worker and a server process
under the daemon.  6-13 minutes as a
command on an H100 (by the host's speed), of which 35-50 s are nvcc (the int8 core's sources
are the slowest; all sources build at once).
Phases:

  1. build    compile every kernel from `anakin_tpu_torch/csrc` (one nvcc
              per source, all at once) and print what ptxas says; then the
              SASS of the depthwise and fused-block kernels (`cuobjdump
              -sass`): each kernel's instructions and its loops' sizes and
              opcodes, from which the instructions an output are counted;
  2. resnet   one forward through `Net.prediction` with every kernel's
              launch count set to 0 just before and read just after:
              matmul_int8 must launch 40 times and conv3x3_int8 13 times,
              and no weight may be prepared (transposed to [N][K]) within
              the step: the Net prepared all 53 when it was built; the
              softmax must be finite rows summing to 1; then ms/step and
              img/s from CUDA events, and one profiled step;
  3. kernels  each ResNet kernel's wrapper against its plain PyTorch version
              on the card, on random int8 data at every distinct shape and
              epilogue of the path, with the weight prepared once as the Net
              does: int8 outputs equal, float outputs within rtol 1e-6; the
              tile configuration each shape takes; timed by CUDA-graph
              replay over copies of the operands that rotate them out of L2
              (and, as context, by events around an eager loop on one set of
              operands, as PR 1-5 timed it) beside the plain version, the
              bound and, for the GEMM, `torch._int_mm`; PyTorch has no int8
              convolution on CUDA, so the 3x3 has no library call, and
              cuDNN's bf16 conv on the same shapes is printed as a reference
              only;
  4. cpu/gpu  ResNet at batch 2 on the card and on the CPU: equal top-1 and
              softmax within rtol 5e-3 and atol 1e-4; then a `dense` node
              and the attention projection under the process-wide
              `torch.set_float32_matmul_precision("high")` against float64:
              within 1e-6 of |x| @ |w| (the ops scope TF32 off themselves;
              this script sets no TF32 flag), while the same product with no
              scope, the control, must exceed that (TF32);
  5. llm A    `GenerationSession(batch 8, bf16, int8 KV cache)` generates 32
              greedy tokens after a 512-token prompt: the prefill (bucket
              512, so flash) must launch flash_attention 16 times, all on
              flash_wgmma (`launches_wgmma`; so must phase 15's admissions,
              phase 16's prefills and phase 17's tuned forward); tokens in
              range, logits finite; prefill ms, decode ms per token step and
              tokens/s from CUDA events; one profiled decode step; then
              (5 b) the session's default precision, float32, at b8 on the
              same prompt: the "auto" prefill (the float32 flash route, 16
              launches) and `prefill_attention="dense"` (none), last-position
              logits within phase 8's 1.5% of the largest and first tokens
              equal wherever the dense top-2 gap exceeds it; both ms;
  6. llm B    the w4 decode step (`weight_only_quantize(bits=4)` of the
              int8-KV aligned decode graph) through `Net(precision="bf16")`
              for 32 chained greedy steps: 33 matmul_w4 launches a step;
              ms per token step, tokens/s, one profiled step; then (6 b)
              the same step in float32 (`Net(precision="fp32")`) from random
              int8 caches: one eager step with 33 launches, all on the
              float32 routes, then captured (`Net.compile`), equal to the
              eager step and timed by replay;
  7. kernels  flash_attention and matmul_w4 against their plain versions on
              the card at every distinct shape of paths A and B, plus a
              ragged S = 300 with segment ids, S = 2048, float32 inputs,
              and the bf16 kernel's other paths (one, two and four query
              heads per kv head, an odd group, D = 64 and 32, S = 128 k + 1,
              no causal mask), and the head dims 80, 96 and 256 (ragged
              lengths too); the float32 route at D = 32 (an odd group, S
              129), 64, 80 (segment ids), 96 and 128, and non-causal
              cross-attention (S 300 over 700 keys) in both dtypes, bf16 D
              = 64 with ragged lengths; each flash row printing its route
              (`ak_flash_attention_route`: flash_wgmma for bf16 at D 64,
              128 and 256, flash_bf16 for the other bf16 head dims,
              flash_tf32 for float32; `check_flash_routes` holds each row
              to its shape) and SDPA's time beside its own; matmul_w4 with bf16
              scales (as the net hands
              them over) and float32 ones, M = 1, 5, 16 (the edges of the
              M <= 16 route) and 4096, N = 1003 (the byte-by-byte path), K
              = G = 128 (one group, one split), float32 x, and the groups
              the quantizer writes beside 128 (32, and 96 over K = 96 and
              1920, each timed beside the G = 128 case); the shapes of
              phase 15's bucket admissions: flash at S = 768, 1024 and 1536,
              matmul_w4 at M = 8 L for buckets 64 to 1536 (the M > 16
              wgmma route; bucket 64's 8192 -> 2048 product splits K in a
              cluster), each matmul_w4 row printing its route
              (`ak_matmul_w4_route`) and splits of K; the wgmma route's
              edges untimed (M 17 and 130, N 1003 at M 130, K = G = 128
              and G = 64 at M 4096, the tp-2 halves N / 2 and K / 2 at
              buckets 64 and 512); float32 x at phase 6 b's three shapes,
              M 5 and 4096, G 32 at M 8 and 4096 (and bf16 G 32 and 96 at
              M 4096), untimed its edges (M 1, 16, 17, 130, N 1003, K = G =
              128, G 64, the tp-2 halves, a second half-chunk past K) and
              groups that go to w4_rows (48, K = G = 80); every row must
              have taken the route its shape asks for (`w4_route_wanted`:
              small / wgmma for bf16 x by M, small_tf32 / wgmma_tf32 for
              float32 x, rows only for a group not a multiple of 32), and
              float32 rows are bound by two TF32 products a product at the
              TF32 rate; tolerances as
              each kernel's source states them; each timed beside its plain
              version, its bound (and its share of it), a library call
              (`scaled_dot_product_attention`, `torch._weight_int4pack_mm`)
              and, for matmul_w4 at M > 16, dequant + `torch.matmul`;
  8. cpu/gpu  the LLM at full width and 2 layers, batch 2, 512-token prompt,
              on the card (flash prefill) and on the CPU (dense prefill):
              last-position logits and one teacher-forced w4 decode step
              within 1.5% of the largest logit, greedy tokens equal wherever
              the CPU's top-2 gap exceeds that; the same w4 step in float32
              (5 launches on the float32 routes) within 1e-3;
  9. mobilenet for v1, then v2: `calibrate` on the card, `quantize_graph`,
              `Net(precision="bf16")`, one b128 forward with the counts set
              to 0 just before and read just after: depthwise3x3_int8 must
              launch 13 / 17 times, matmul_int8 14 / 35, conv3x3_int8
              never; softmax rows finite and summing to 1; ms/step and
              img/s from CUDA events, one profiled step;
 10. kernel   depthwise3x3_int8 against its plain version at every distinct
              shape of the two forwards (9 + 10) with the path's epilogue,
              plus a ragged C, odd H/W at stride 1 and 2 (25 x 25, 7 x 9),
              float32 and bf16 outputs, leaky_relu, no bias and a misaligned
              x: int8 outputs equal,
              float outputs within rtol 1e-6; timed by CUDA-graph replay
              with x rotated out of L2, beside its bound (each shape's share
              of it printed and in the JSON), its plain version and, as
              context only, cuDNN's bf16 grouped conv;
 11. cpu/gpu  v1 and v2 at b2 from one graph: `calibrate` scales on the
              card and the CPU within rtol 1e-4; the int8 net on both, node
              by node on the CPU's inputs (int8 kernel outputs equal, the
              fp32 stem's requant within 1 LSB, float outputs within 8e-3),
              whole from the CPU's int8 stem output (int8 edges equal,
              softmax within rtol 5e-3 / atol 1e-4), and whole from the
              image (top-1 equal wherever the CPU's top-2 gap exceeds twice
              that tolerance: the fp32 stem conv may round an element the
              other way on the two devices, and random weights amplify it).

 12. llm B v2 the distinct-position w4 decode ladder (`tools/exp_w4_r4.py bench
              --weights w4 --pos distinct --variant v2` of the JAX package):
              the int8-KV decode graph with per-slot positions and
              `cache_update="rows"`, `weight_only_quantize(bits=4)`, every
              `dense_w4` set to `impl="pallas"`, `variant="v2"`, b8, bf16,
              positions min(287 b, 2015) + t, 32 chained greedy steps: 33
              matmul_w4 v2 launches a step and no v1; ms per token step,
              tokens/s, one profiled step; then the same graph in v1, one
              step from the same feed: logits within phase 8's 1.5% of the
              largest, greedy tokens equal wherever the top-2 gap exceeds it;
 13. kernel   matmul_w4 v2 against its plain version at the three path
              shapes (scales in bf16, as the net hands them over), float32
              x, a prefill-sized M in bf16 and in float32 scales, float32
              scales with bf16 x (where v2's dequantized weights differ
              from v1's; the count is printed), phase 7's edges of the
              M <= 16 route (M = 1 and 16, N = 1003, K = G = 128), its
              groups 32 and 96, float32 x at M 5 and 4096 and, untimed,
              its edges of the wgmma route and the half-chunk edges;
              tolerance as phase 7; timed beside its
              bound, its plain version, v1 on the same inputs and
              `torch._weight_int4pack_mm`;
 14. bottleneck the 12 identity blocks of phase 2's ResNet-50 b128 net (2/3/5/2
              over the stages: 1x1 relu -> 3x3 relu -> 1x1 + the block's
              input, `models.identity_bottlenecks`), each through
              `bottleneck_int8` from the net's tapped input with the net's
              params and the weights the net prepared when it was built
              (`net.prepared`), the counts set to 0 just before and read
              just after (12 launches, nothing else, and no weight
              prepared): outputs equal to the net's block outputs (int8 bit
              for bit, the last block's float32 within rtol 1e-6); then the
              kernel, on prepared weights and on raw ones, against its
              plain version at the four stage shapes, no bias, float32 and
              bf16 outputs, and H, W not a multiple of the band: int8 equal,
              float within rtol 1e-6; timed by CUDA-graph replay with x
              rotated out of L2, beside its bound (each shape's share of it
              printed and in the JSON), its plain version and the unfused
              chain matmul_int8 -> conv3x3_int8 -> matmul_int8 on the same
              block (PyTorch has no int8 convolution on CUDA: no library
              call); then two blocks narrower than the kernel's multiples
              of 64 channels (C 32 / P 8, C 96 / P 40), which the wrapper
              widens with zero channels: bit-equal to the plain version on
              prepared and on raw weights, one launch a call, untimed;
 15. scheduler the port's `DecodeScheduler` on the LLM weights: b8, bf16,
              int8 KV cache, `weight_only="w4"`, bucket admission, cache
              views off, one scheduler; 12 greedy requests (prompts of 40,
              200, 512, 700, 1000 and 1500 tokens, buckets 64 to 1536, so
              flash from 512) of 64 new tokens, first through the per-step
              path (`fuse_window` 0: one captured step replayed a token),
              then with `fuse_window` 16 (read at every step) and the
              counts set to 0 just before and read just after: one request
              whose first window captures the window graph, then the 12
              requests through fused windows (one graph replay a window),
              three of them carrying a stop token their output reaches:
              flash_attention and matmul_w4 launch (at warm-up and capture
              and in the eager bucket prefills; a replay counts nothing)
              and nothing else, every M > 16 launch (the admissions'
              projections, recorded by shape) on the wgmma route (its own
              count, `matmul_w4.launches_wgmma`); every request's tokens equal the per-step
              path's, the stopped ones up to and ending on their stop
              token; the host seconds of each graph's weight-only rewrite,
              tokens/s, ms a window step; one captured decode step
              bit-equal to the eager step in logits and caches; the
              admission ms of each bucket; one window replayed, profiled
              (host launch calls, device busy) and timed beside the same
              window run eagerly, the two giving equal tokens; then, at 2
              of the 16 layers, chunked admission with cache views on and
              device sampling in the windows (three requests: top_k 1 must
              give the greedy tokens, every token in range, the chunk step
              and the windows captured graphs).

 16. speculative `SpeculativeSession` on the LLM weights (bf16, int8 KV cache,
              k 4, batch 1, a 512-token prompt, 64 new tokens) with a random
              draft (vocab 32000, E 256, 4 heads, 2 layers): each of its three
              loops (`generate`, `generate_round_fused`: one captured round a
              replay, `generate_fused`: a window of 8 rounds a replay) with the
              counts set to 0 just before and read just after (flash_attention
              once a layer in each prefill, nothing else); ms per token beside
              `GenerationSession`'s b1 greedy; rounds, acceptance, the host's
              graph launches a round; the three loops' tokens equal; the
              common prefix with greedy and the target's top-2 gap where they
              part; then draft = target at 2 of the 16 layers in float32:
              one round (k + 2 tokens) accepts every draft on each loop, and
              over 64 tokens every loop's tokens equal greedy's, the first
              loop's generate counted (4 float32 flash launches: the two
              prefills);
 17. tuned    the long-context prefill of the JAX suite (vocab 8000, E 1024, 8
              heads, 4 layers, b2, S 2048, a bf16 net): `optimize(autotune=
              True, tuner_cache=build/...)`, the tuner's choice and both
              candidates' times, its float32 flash launches counted (the
              flash candidate's 16 calls); the dense and the tuned net's ms
              per batch with their flash launches counted, the tuned net's
              logits within phase 8's 1.5% of the dense net's largest; a
              second `optimize` that reads the cache and times nothing;
 18. cnn      `calibrate(method="max")` on the card, then VGG16 int8 b8,
              GoogLeNet bf16 and int8 b8, ShuffleNet v1 (groups 3) int8 b128
              at 224 px (bf16 nets), each forward with the counts set to 0
              just before and read just after (conv3x3_int8 13 / 10,
              matmul_int8 3 / 47 / 95, depthwise3x3_int8 16), ms/step, img/s
              and a profiled step; every distinct int8 kernel shape of the
              three int8 nets against its plain version (untimed: int8 equal,
              float within rtol 1e-6); card against CPU at b2 and 64 px, node
              by node; a `conv2d_w8` ResNet-50 card against CPU;
              `horizontal_combine` on GoogLeNet equal to the uncombined graph;
              a `moe_ffn` node card against CPU.
 19. detection `calibrate(method="max")` on the card, then SSD300-VGG16 (300
              px, 21 classes), YOLOv3-tiny (416 px, 80 classes) and Faster
              R-CNN (ResNet-50-C4, 224 px, proposals pre 1024 / post 128,
              roi_align 14 x 14) at b1, each as a bf16 net with float and
              with int8 weights (the JAX suite's `ssd_vgg16_bf16_b1`,
              `faster_rcnn_*_b1`, `yolo_v3_tiny_*_b1`): one forward with the
              counts set to 0 just before and read just after
              (conv3x3_int8 and matmul_int8 exactly as the int8 graph's
              nodes route them, nothing in a bf16 net), the outputs checked
              (slabs well-formed, YOLO boxes in the image), ms/step, a
              profiled step (device busy share, kernel launches a step), each
              int8 kernel's calls and distinct shapes; the forward captured
              by `Net.compile` (outputs equal to eager, ms/step replayed);
              every distinct int8 kernel shape bit-equal to its plain
              version; card against CPU at b1, full width and a cut image
              size (SSD 264, YOLO and Faster R-CNN 128 px; Faster R-CNN at
              16 proposals), int8, node by node on the CPU's inputs (int8
              kernel outputs equal, detection slabs and proposals valid on
              the same rows within DET_SLAB_RTOL), then the whole net from
              the image (the same valid slab rows, images and labels, the
              values within DET_SLAB_RTOL), node by node on each device's
              own values: the first node that parts and the first whose
              float output parts beyond 8e-3 of its largest value, and the
              net again from just after the first, every edge made before
              it shared from the CPU (reported);
 20. segmentation FCN-8s lite and ICNet lite at their defaults (b1, 64 px),
              float32 and bf16 nets on the card (no int8 kernel: they have
              no int8 route), ms/step; card against CPU: float32 logits
              within SEG_LOGIT_TOL and label maps equal where decided; bf16
              node by node on the CPU's inputs.
 21. rnn      46 op entries (the sequence ops, the tensor and nn ops that
              no earlier phase runs) once each on the card against the CPU at
              small shapes, forced ties, out-of-range gather and one_hot
              indices and overlapping unpool windows included; then
              `calibrate(method="max")` on the card and the LSTM language
              model (the JAX suite's `lstm_lm_bf16_b8xT64`: b8 x T64, vocab
              10,000, E 256, H 512, 2 layers), the text classifier (b4 x
              T64) and the NER tagger (b4 x T48), each a bf16 net with float
              and with int8 weights: one forward with the counts set to 0
              just before and read just after (matmul_int8 once in an int8
              net, the projection; nothing in a float net), the output
              checked, ms/step eager and captured by `Net.compile` (outputs
              equal), tokens/s, and for the LM a profiled eager and captured
              step (busy share, kernel launches a step); every distinct int8
              kernel shape bit-equal to its plain version; card against CPU
              at full width, b2 x T16: the float32 nets edge by edge within
              RNN_F32_TOL, captured equal to eager, the int8 nets node by
              node on the CPU's inputs (dense_int8 outputs and the tags
              equal), the int8 nets whole (reported).
 22. model io a ResNet-50 `torch.nn.Module` (the layout of `models/resnet.py`,
              seed 0, BN statistics from default_rng(0)) through
              `from_torch` at b1 and `optimize`: the float32 net at b32
              against the module's own forward on the card (TF32 off), top-1
              equal and logits within IO_LOGIT_TOL of the largest;
              `calibrate(method="max")` on the card over two b1 batches,
              `quantize_graph`, a bf16 net: one b32 forward with the counts
              set to 0 just before and read just after (matmul_int8 40,
              conv3x3_int8 13, no weight prepared); every distinct int8
              kernel shape of that b32 forward bit-equal to its plain
              version; the b1 eager forward timed with the wrappers
              launching directly against every wrapper going through its
              registered op (`torch.compiler.is_compiling` patched true),
              in interleaved windows (outputs and launches equal); `save_model` ->
              `load_model` (params byte-equal, graph JSON equal, outputs
              bit-equal; bytes, save and load ms); `export_program` ->
              `load_program`, one call with the counts set to 0 just before
              and read just after (the same 40 + 13, outputs bit-equal),
              ms/step beside the `Net`'s; the module through torch's ONNX
              exporter and `from_onnx` (float32 output within IO_LOGIT_TOL
              of the from_torch graph's); the converter CLI on the saved
              module (its directory equal to `save_model`'s, byte for
              byte); the kernel build cache in two processes (the second,
              with no toolkit, builds nothing); `compare_accuracy` of the
              float and int8 graphs over two b32 batches.
 23. serving  a, after phase 16 on the same LLM weights: a DecodeScheduler
              at phase 15's settings behind the Generate RPCs on a gRPC
              socket (the service's monitor polling every 50 ms); six
              concurrent clients (Generate and GenerateStream, prompts of
              SCHED_LENGTHS, 32 new tokens) with the counts set to 0 just
              before and read just after (flash_attention and matmul_w4
              only); tokens equal to a direct `submit` of the same requests,
              each stream's frames equal to its final tokens, NOT_FOUND for
              an unknown model, the windows captured graphs while the monitor
              polled, every flash and matmul_w4 shape of the scheduler's
              graphs one that phase 7 checks; then a timed window of 16
              requests from 8 clients once every window graph exists.  b, after phase 22 on the
              directory it saved (the converted ResNet-50 int8, 224 px): a
              ContinuousBatcher over the server's own factory (buckets 1, 2,
              4, 8, bf16), 23 requests in bursts, the counts set to 0 just
              before and read just after (40 matmul_int8 + 13 conv3x3_int8 a
              batch), each result bit-equal to a fresh `Net` of its bucket on
              the same zero-padded batch; every distinct int8 shape of the
              four buckets bit-equal to its plain version; a Worker over the
              b1 net (3 threads, sync and async in FIFO order, equal to
              `net.prediction`); a ServingDaemon over a server process on the
              card (ListModels, the device status, the child terminated and
              restarted, Evaluate again); after a warm-up, timed windows of
              200 Evaluate requests one at a time (each bit-equal to the b1
              net's) and 256 from 8 clients at once: round trip and the
              server's `duration_ms` by percentile; the b1 and b8 forwards in
              process (CUDA events), boot and restart seconds, `plan_memory`
              of the b8 graph beside the allocator's peak of a b8 forward.

Prints the card's name and power limit, a `{"kernels": [...]}` line, and as
its last line `{"ok": true, "device": {...}}`.  The kernels line's
`matmul_w4_wgmma` entry is matmul_w4's M > 16 route, of either variant,
over phase 15's counted round: its launches there, and its times summed
over phase 7's rows at the shapes it launched.  The `matmul_w4_f32` entry
is matmul_w4's float32 routes over phase 6 b's float32 step, summed the
same way.  The `flash_attention_f32`
entry is flash_attention's float32 route over one tuning of phase 17's key
(its launches there, times from phase 7's row at the tuner's shape); the
`flash_attention` entry holds the bf16 route's rows only.  Float32 flash
bounds take three TF32 products a product at the TF32 tensor-core rate (the
kernel's split).  Each entry of the kernels
line also has `launches_by_path`, its launches in each int8 detector's
and RNN net's forward, in the converted ResNet-50's int8 forward and in
the loaded program's call (phase 22), in one batch of the served ResNet-50
and in the six Generate requests (phase 23), the float32 session prefill
(phase 5 b), the draft = target float32 generate (phase 16) and each
rank's tp-2 float32 w4 step (phase 24).
`--kernels-only` runs phases 1, 7 and 13 and
phases 18, 19 and 21's kernel checks alone (no main path, so neither of
those lines) and writes `build/chip_smoke_kernels.json`; `--w4-only` runs
phase 1, phase 7's timed matmul_w4 rows at the bucket admissions and phase
15's admission ms per bucket (no requests served), using only what the
port had before the wgmma route, so a copy of the script times an earlier
tree too; `--phase24-only` runs phases 1 and 24.  Any failed check raises and
the script exits non-zero; so does a machine without a GPU.  Details go to
`build/chip_smoke.json` as well.
"""

import collections
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_INT8_OPS = 1979e12     # H100 SXM dense int8 tensor-core rate, op/s
PEAK_BF16_OPS = 989e12      # H100 SXM dense bf16 tensor-core rate, flop/s
PEAK_TF32_OPS = 495e12      # H100 SXM dense TF32 tensor-core rate, flop/s
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
    # its float32 route (flash_tf32), over one tuning of phase 17's key
    "flash_attention_f32": ("anakin_tpu_torch/csrc/flash_attention.cu",
                            "anakin_tpu/kernels/flash_attention.py:101"),
    "matmul_w4": ("anakin_tpu_torch/csrc/matmul_w4.cu",
                  "anakin_tpu/kernels/matmul_w4.py:129"),
    "depthwise3x3_int8": ("anakin_tpu_torch/csrc/depthwise3x3_int8.cu",
                          "anakin_tpu/kernels/depthwise_int8.py:171"),
    "matmul_w4_v2": ("anakin_tpu_torch/csrc/matmul_w4.cu",
                     "anakin_tpu/kernels/matmul_w4.py:75"),
    # the M > 16 route (w4_wgmma) of both variants, on phase 15's admissions
    "matmul_w4_wgmma": ("anakin_tpu_torch/csrc/matmul_w4.cu",
                        "anakin_tpu/kernels/matmul_w4.py:129"),
    # the float32 routes (w4_small on TF32, w4_wgmma_tf32) of both variants,
    # on phase 6 b's float32 w4 decode step
    "matmul_w4_f32": ("anakin_tpu_torch/csrc/matmul_w4.cu",
                      "anakin_tpu/kernels/matmul_w4.py:129"),
    "bottleneck_int8": ("anakin_tpu_torch/csrc/bottleneck_int8.cu",
                        "anakin_tpu/kernels/bottleneck_int8.py:134"),
}


def log(*a):
    print(*a, flush=True)


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def check_ptxas(out: str, kernel: str):
    """ptxas's report (`out`, empty where the library was built before) of
    every instantiation of `kernel`: no stack frame, no spill, and no note
    of ptxas's that it serialized its wgmma or ignored a setmaxnreg
    (C75xx)."""
    lines, bad, name = out.splitlines(), [], None
    for line in lines:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and kernel in name and "stack frame" in line and \
                re.findall(r"(\d+) bytes", line) != ["0", "0", "0"]:
            bad.append(f"{name}: {line.strip()}")
        if re.search(r"\(C75\d\d\)", line) and kernel in line and (
                "serialized" in line or "ignored" in line):
            bad.append(line.strip())
    if bad:
        raise AssertionError(f"ptxas on {kernel}: " + "; ".join(bad))


def sass_loops(lib_path: str):
    """What `cuobjdump -sass` shows of each kernel in a built library:
    {function: (instructions, [loops])}, a loop being (its instructions,
    {opcode: count}) from a backward branch's target to the branch, nested
    loops counted with their own; for a kernel with no loop (straight-line
    code), the whole function as its one entry."""
    import re
    from torch.utils.cpp_extension import CUDA_HOME

    text = subprocess.run(
        [os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump"),
         "-sass", lib_path], capture_output=True, text=True, check=True,
        timeout=300).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = ([], {})
            continue
        if name is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:  # a label (nvdisasm's form)
            funcs[name][1][m.group(1)] = len(funcs[name][0])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:  # an address is a label too (cuobjdump branches to addresses)
            funcs[name][1]["0x" + m.group(1).lstrip("0").lower()] = len(
                funcs[name][0])
            funcs[name][0].append(m.group(2))
    out = {}
    for name, (ins, labels) in funcs.items():
        back = []  # (target index, branch index) of each backward branch
        for i, t in enumerate(ins):
            m = re.search(r"\bBRA\S*\s+(?:`\((\.L_x_\d+)\)|0x0*([0-9a-f]+))",
                          t)
            if not m:
                continue
            target = m.group(1) or "0x" + m.group(2).lower()
            if target in labels and labels[target] < i:
                back.append((labels[target], i))
        loops = []
        for t0, i in sorted(set(back)):
            if i - t0 < 3:
                continue  # the trap loop at the end
            ops = {}
            for t in ins[t0:i + 1]:
                op = next(w for w in t.split() if not w.startswith("@"))
                op = op.split(".")[0]
                ops[op] = ops.get(op, 0) + 1
            loops.append((i + 1 - t0, ops))
        if not loops:  # straight-line code: the whole function's opcodes
            ops = {}
            for t in ins:
                op = next(w for w in t.split() if not w.startswith("@"))
                ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
            loops.append((len(ins), ops))
        out[name] = (len(ins), loops)
    return out


def log_sass(lib_path: str, tag: str):
    """Phase 1's SASS lines for one library: each kernel's instruction
    count and its innermost loops' sizes and opcodes."""
    res = {}
    for name, (n, loops) in sass_loops(lib_path).items():
        res[name] = dict(instructions=n, loops=loops)
        log(f"[sass] {tag} {name[:100]}: {n} instructions")
        for size, ops in loops:
            top = sorted(ops.items(), key=lambda kv: -kv[1])
            log(f"[sass]   {'loop' if size < n else 'all'} of {size}: " +
                " ".join(f"{k} {v}" for k, v in top))
    return res


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


def kernel_calls(graph, shapes, local=None):
    """The kernel calls one forward makes: [(kernel, config)], where a
    config holds the GEMM or conv shape and the epilogue, read off the
    graph's int8 nodes and the edge shapes of a run.  `local`: a
    tensor-parallel rank's params ({edge: its block}); a node then makes
    its call at its weight's out channels."""
    from anakin_tpu_torch.ops.quantized import _depthwise_kernel, conv_kind

    calls = []
    for node in graph.nodes.values():
        if node.op not in ("conv2d_int8", "dense_int8"):
            continue
        w = (graph.params if local is None else local)[node.inputs[1]]
        out = tuple(shapes[node.outputs[0]])
        if local is not None:
            out = out[:-1] + (int(w.shape[-1]),)
        epi = dict(activation=node.attr("activation"),
                   bias=bool(node.attr("has_bias")),
                   residual=bool(node.attr("has_residual")),
                   requant=node.attr("out_scale") is not None)
        groups = int(node.attr("groups", 1)) if node.op == "conv2d_int8" else 1
        if groups > 1 and not _depthwise_kernel(node, w, epi["residual"]):
            # the grouped route: matmul_int8 once per group
            og = w.shape[3] // groups
            calls += [("matmul_int8", dict(
                M=int(np.prod(out[:-1])), K=int(np.prod(w.shape[:-1])), N=og,
                **epi))] * groups
        elif node.op == "conv2d_int8" and groups > 1:
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


def check_kernel(kernel, cfg, gen, timed=True):
    """Wrapper against plain version on the card, on the weight prepared
    once as a Net prepares it; times of the kernel, of the plain version and
    of the library's product (`torch._int_mm`; for the 3x3, cuDNN's bf16
    conv as a labelled reference: not the same function), each over enough
    copies of its operands (100 MiB or more) that every call reads them from
    HBM, as a forward does.  `timed=False` checks only.  Returns a result
    dict."""
    import torch.nn.functional as F
    from anakin_tpu_torch.kernels.conv_int8 import (conv3x3_int8,
                                                    conv3x3_int8_plain)
    from anakin_tpu_torch.kernels.matmul_int8 import (igemm_config,
                                                      matmul_int8,
                                                      matmul_int8_plain,
                                                      prepare_b)

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
    pb = prepare_b(b)
    want = plain(a, b, ws, bias, res, **kw)
    got = fn(a, pb, ws, bias, res, **kw)
    torch.cuda.synchronize()
    if got.dtype == torch.int8:
        err = float((got.int() - want.int()).abs().max())
        ok = err == 0
    else:
        d = (got.float() - want.float()).abs()
        err = float(d.max())
        ok = bool((d <= 1e-6 * want.float().abs()).all())
    if not timed:
        fn.launches = launches
        bms, by = bound(kernel, cfg)
        return dict(kernel=kernel, **cfg, ok=ok, max_abs_err=err, ms=None,
                    plain_ms=None, library_ms=None, bound_ms=bms, bound_by=by)

    def n_copies(*ts):
        return max(2, -(-100 * 2 ** 20 // sum(t.numel() * t.element_size()
                                              for t in ts if t is not None)))

    def clone(t):
        return None if t is None else t.clone()

    nc = n_copies(a, pb.t, res)
    copies = [(clone(a), pb._replace(t=pb.t.clone()), clone(res))
              for _ in range(nc)]
    ms = graph_ms(rotating(lambda a_, b_, r_: fn(a_, b_, ws, bias, r_, **kw),
                           copies), iters=nc * -(-20 // nc))
    # events around an eager loop on one set of operands, as PR 1-5 timed
    # this phase: context only (the host's time per call shows where it
    # exceeds the kernel's)
    eager_ms = cuda_ms(lambda: fn(a, pb, ws, bias, res, **kw), iters=20)
    plain_ms = graph_ms(rotating(lambda a_, b_, r_: plain(
        a_, b_, ws, bias, r_, **kw), copies[:2]), iters=2)
    fn.launches = launches  # the comparison's launches are not the path's
    del copies
    library_ms = cudnn_ms = None
    if kernel == "matmul_int8":
        nc = n_copies(a, b)
        lib_copies = [(a.clone(), b.clone()) for _ in range(nc)]
        library_ms = graph_ms(rotating(torch._int_mm, lib_copies),
                              iters=nc * -(-20 // nc))
        m, n, k = cfg["M"], cfg["N"], cfg["K"]
    else:
        xb = a.to(torch.bfloat16).permute(0, 3, 1, 2)
        wb = b.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
        nc = n_copies(xb, wb)
        lib_copies = [(xb.clone(), wb.clone()) for _ in range(nc)]
        cudnn_ms = graph_ms(rotating(lambda x_, w_: F.conv2d(x_, w_, padding=1),
                                     lib_copies), iters=nc * -(-20 // nc))
        m, n, k = cfg["N"] * cfg["H"] * cfg["W"], cfg["O"], 9 * cfg["C"]
    del lib_copies
    bm, bn, splits = igemm_config(m, n, k)
    bms, by = bound(kernel, cfg)
    return dict(kernel=kernel, **cfg, ok=ok, max_abs_err=err,
                ms=ms, eager_ms=eager_ms,
                tile=f"{bm}x{bn}",
                k_splits=splits, plain_ms=plain_ms, library_ms=library_ms,
                cudnn_bf16_conv_ms=cudnn_ms, bound_ms=bms, bound_by=by)


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


def kernel_counters():
    """{kernel: (wrapper, name of its launch count)}: matmul_w4 counts its
    two variants apart, and its M > 16 route's launches and its float32
    routes' launches of either variant beside them; flash_attention its
    float32 route's launches beside all of its launches."""
    from anakin_tpu_torch.kernels import (bottleneck_int8, conv3x3_int8,
                                          depthwise3x3_int8, flash_attention,
                                          matmul_int8, matmul_w4)

    counters = {"matmul_int8": matmul_int8, "conv3x3_int8": conv3x3_int8,
                "flash_attention": flash_attention, "matmul_w4": matmul_w4,
                "depthwise3x3_int8": depthwise3x3_int8,
                "bottleneck_int8": bottleneck_int8}
    counters = {k: (fn, "launches") for k, fn in counters.items()}
    counters["matmul_w4_v2"] = (matmul_w4, "launches_v2")
    counters["matmul_w4_wgmma"] = (matmul_w4, "launches_wgmma")
    counters["matmul_w4_f32"] = (matmul_w4, "launches_f32")
    counters["flash_attention_f32"] = (flash_attention, "launches_f32")
    return counters


def reset_counts():
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in kernel_counters().items()}


def no_launches():
    return {name: 0 for name in kernel_counters()}


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
    by_name, host_launches = {}, {}
    for ev in prof.key_averages():  # kernels only: host ops are not device time
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            by_name[ev.key] = (ev.self_device_time_total / 1e3, ev.count)
        elif "LaunchKernel" in ev.key or "GraphLaunch" in ev.key:
            host_launches[ev.key] = ev.count  # the host's launch calls
    busy_ms = sum(t for t, _ in by_name.values())
    launches = sum(c for _, c in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    if busy_ms > 0:
        log(f"[{tag}] profiled step: wall {wall_ms:.2f} ms under the profiler, "
            f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of "
            f"it, {100 * busy_ms / step_ms:.1f}% of the unprofiled step) in "
            f"{launches} kernel launches; host launch calls {host_launches}")
        for k, (t, c) in top:
            log(f"[{tag}]   {t:9.3f} ms  x{c:<4d} {k[:90]}")
    else:
        log(f"[{tag}] the profiler recorded no device time: not measured")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                busy_share_of_step=busy_ms / step_ms, kernel_launches=launches,
                host_launch_calls=host_launches,
                top=[(k, t, c) for k, (t, c) in top])


# ------------------------------------------------------------------ ResNet

def resnet_phases(report, card):
    """Phases 2-4.  Returns the kernel check rows, the path's counts and
    (net, graph, input) for phase 14."""
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

    from anakin_tpu_torch.kernels.matmul_int8 import prepare_b

    prepared_at_build = len({id(p) for p in net.prepared.values()})
    reset_counts()
    prepare_b.calls = 0
    y = net.prediction({"input": x})[out_edge]
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[path] launches in one forward: {counts}; weights prepared at "
        f"build {prepared_at_build}, in the forward {prepare_b.calls}")
    if counts != dict(no_launches(), matmul_int8=40, conv3x3_int8=13):
        raise AssertionError(f"expected 40 + 13 kernel launches, got {counts}")
    if prepare_b.calls or prepared_at_build != 53:
        raise AssertionError(f"expected 53 weights prepared at build and no "
                             f"transpose in a step, got {prepared_at_build} "
                             f"and {prepare_b.calls}")
    yf = y.float()
    if tuple(y.shape) != (BATCH, 1000) or not torch.isfinite(yf).all():
        raise AssertionError(f"bad output {tuple(y.shape)}")
    if (yf.sum(-1) - 1).abs().max() > 2e-2:  # bf16 softmax rows
        raise AssertionError("softmax rows do not sum to 1")

    step_ms = cuda_ms(lambda: net.prediction({"input": x}), iters=10)
    report["path"] = dict(batch=BATCH, image=IMAGE, precision="bf16",
                          launches=counts, weights_prepared=prepared_at_build,
                          transposes_in_step=prepare_b.calls,
                          ms_per_step=step_ms,
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
        lib = ("n/a" if r["library_ms"] is None else
               f"{r['library_ms']:.4f}")
        if r["cudnn_bf16_conv_ms"] is not None:
            lib += f" cudnn-bf16-conv={r['cudnn_bf16_conv_ms']:.4f}"
        log(f"[kernel] {kernel:12s} {shape:22s} x{n_calls} act={r['activation']}"
            f" res={int(r['residual'])} int8out={int(r['requant'])} "
            f"tile={r['tile']} splits={r['k_splits']} "
            f"err={r['max_abs_err']:g} ms={r['ms']:.4f} "
            f"eager={r['eager_ms']:.4f} "
            f"plain={r['plain_ms']:.3f}"
            f" lib={lib} bound={r['bound_ms']:.4f} ({r['bound_by']})")
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel differs from its plain version: {bad}")
    report["kernel_configs"] = results
    for kernel in ("matmul_int8", "conv3x3_int8"):
        rs = [r for r in results if r["kernel"] == kernel]

        def total(key):
            return sum((r[key] or 0.0) * r["calls_per_run"] for r in rs)

        log(f"[kernel] {kernel} per forward: {total('ms'):.4f} ms, eager "
            f"(events around a loop of calls) {total('eager_ms'):.4f} ms, bound "
            f"{total('bound_ms'):.4f} ms, library {total('library_ms'):.4f}, "
            f"cudnn bf16 conv {total('cudnn_bf16_conv_ms'):.4f}")
    log("[kernel] conv3x3_int8 has no library_ms: PyTorch has no int8 "
        "convolution on CUDA (cuDNN's bf16 conv is a reference only)")

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
    report["float32_check"] = float32_check()
    return results, counts, (net, g128, x)


FP32_LIMIT = 1e-6  # of |x| @ |w|: float32 gives ~4e-8 here, TF32 ~6e-5


def float32_check():
    """A `dense` node and the attention projection on the card under the
    process-wide `torch.set_float32_matmul_precision("high")` (which lets
    cuBLAS use TF32) against a float64 reference: the ops scope TF32 off
    themselves, so the error must stay below FP32_LIMIT of |x| @ |w|.  The
    control, the same product with no scope (`torch.matmul` under "high"),
    must exceed it: otherwise the check could not see TF32."""
    from anakin_tpu_torch.graph.ir import Node
    from anakin_tpu_torch.ops import get_op
    from anakin_tpu_torch.ops.attention import _project

    rng = np.random.default_rng(5)
    K = 2048
    x = torch.from_numpy(rng.normal(size=(8, 64, K)).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.normal(size=(K, 512)).astype(np.float32)).cuda()
    want = x.double() @ w.double()
    mag = x.double().abs() @ w.double().abs()
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        dense = get_op("dense")(Node("n", "dense", ["x", "w"], ["y"],
                                     dict(axis=2)), [x, w])[0]
        proj = _project(x, w, 4, 128).permute(0, 2, 1, 3).reshape(8, 64, 512)
        control = torch.matmul(x, w)
        torch.cuda.synchronize()
        if torch.get_float32_matmul_precision() != "high":
            raise AssertionError("the ops changed the caller's precision")
    finally:
        torch.set_float32_matmul_precision(saved)
    out = {}
    for name, got in (("dense", dense), ("project", proj),
                      ("control", control)):
        rel = float(((got.double() - want).abs() / mag).max())
        out[name] = rel
        log(f"[fp32] {name} under matmul precision 'high': max |err| / "
            f"(|x| @ |w|) = {rel:.3g} (limit {FP32_LIMIT:g})")
        if name == "control" and rel <= FP32_LIMIT:
            raise AssertionError(f"the unscoped product under 'high' is "
                                 f"within the limit ({rel}): no TF32 to see")
        if name != "control" and rel > FP32_LIMIT:
            raise AssertionError(f"{name} is not float32 under 'high': {rel}")
    return out


# --------------------------------------------------------------------- LLM

LLM_CFG = dict(vocab=32000, embed=2048, heads=16, kv_heads=8, layers=16,
               max_seq=2048)
LLM_BATCH, PROMPT, NEW = 8, 512, 32
# card vs CPU logits, as a fraction of the largest |logit|: about three
# times the 0.4-0.5% measured on an H100 (PERF.md section 6)
LLM_TOL = 0.015
# a float32 w4 step, card vs CPU, as a share of the largest logit: the
# float32 routes' split keeps the products within 2^-21 (phase 24 holds the
# sharded float32 step to the same)
F32_W4_TOL = 1e-3


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
    wgmma0 = wgmma_flash_launches()
    t0 = time.perf_counter()
    tokens = sess.generate(prompt, NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = read_counts()
    log(f"[llm A] launches in one generate (1 prefill + {NEW} steps): {counts}")
    if counts != dict(no_launches(), flash_attention=cfg.layers):
        raise AssertionError(f"expected {cfg.layers} flash_attention launches "
                             f"in the prefill, got {counts}")
    require_wgmma_flash("the prefill", counts, wgmma_flash_launches() - wgmma0)
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


def float32_session_prefill(report, cfg, params, card):
    """Phase 5 b: the session's default precision, float32
    (`GenerationSession(batch 8, precision="fp32")`, float32 KV cache), on
    phase 5's 512-token prompt: the "auto" prefill (bucket 512, so the
    float32 flash route, 16 launches) against `prefill_attention="dense"`
    (none), each once with the counts set to 0 just before and read just
    after; last-position logits within LLM_TOL of the largest, first tokens
    equal wherever the dense prefill's top-2 gap exceeds it; both
    prefills' ms.  Returns the auto prefill's counts."""
    from anakin_tpu_torch.runtime.generate import GenerationSession

    t0 = time.perf_counter()
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (LLM_BATCH, PROMPT)).astype(np.int32)).cuda()
    res, logits = {}, {}
    for name in ("auto", "dense"):
        sess = GenerationSession(cfg, batch=LLM_BATCH, params=params,
                                 precision="fp32", prefill_attention=name,
                                 device="cuda")
        sess._prefill(prompt)  # builds the bucket's net; warm-up
        torch.cuda.synchronize()
        reset_counts()
        lg, _ = sess._prefill(prompt)
        torch.cuda.synchronize()
        counts = read_counts()
        want = cfg.layers if name == "auto" else 0
        if counts != dict(no_launches(), flash_attention=want,
                          flash_attention_f32=want):
            raise AssertionError(f"float32 {name} prefill: expected {want} "
                                 f"float32 flash launches, got {counts}")
        if tuple(lg.shape) != (LLM_BATCH, 1, cfg.vocab) or \
                not torch.isfinite(lg).all():
            raise AssertionError(f"float32 {name} prefill: bad logits "
                                 f"{tuple(lg.shape)}")
        logits[name] = lg[:, 0].float().cpu()
        ms = cuda_ms(lambda: sess._prefill(prompt), iters=3, warmup=1)
        res[name] = dict(prefill_ms=ms, launches=counts)
        log(f"[llm fp32] prefill {PROMPT} tokens x{LLM_BATCH} float32, "
            f"attention {name}: {ms:.3f} ms; flash launches "
            f"{counts['flash_attention_f32']} | {card}")
        del sess
        torch.cuda.empty_cache()
    fa, fd = logits["auto"], logits["dense"]
    scale = float(fd.abs().max())
    err = float((fa - fd).abs().max())
    top2 = torch.topk(fd, 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    same = fa.argmax(-1) == fd.argmax(-1)
    decided = gap > LLM_TOL * scale
    log(f"[llm fp32] auto (flash) against dense: logits max diff {err:.4g} "
        f"({err / scale:.3g} of the largest, tolerance {LLM_TOL}), first "
        f"tokens equal {same.tolist()}; "
        f"{time.perf_counter() - t0:.1f} s")
    if err > LLM_TOL * scale:
        raise AssertionError(f"float32 auto and dense prefill logits differ "
                             f"by {err / scale:.3g} of the largest")
    if not bool(same[decided].all()):
        raise AssertionError("float32 auto and dense first tokens differ "
                             "where decided")
    res.update(max_abs_diff=err, rel_to_max=err / scale,
               tokens_equal=same.tolist())
    report["llm_fp32_prefill"] = res
    return res["auto"]["launches"]


# the w4 weights of the LLM, quantized once for phases 6 and 12
# (`weight_only_quantize`'s `packed`)
W4_PACKED = {}


def w4_ladder(cfg, params, distinct=False, variant=None):
    """The w4 decode ladder: `weight_only_quantize(bits=4)` of the int8-KV
    decode step, aligned positions with blend writes (path B) or distinct
    per-slot positions min(287 b, 2015) + t with row writes (phase 12,
    `tools/exp_w4_r4.py:49-71`); `variant` sets impl="pallas" and the
    variant on every dense_w4 node.  Returns (graph, net, run, feed_at):
    run(steps) chains greedy steps from zero caches and returns the last
    token, logits and caches; feed_at(t, tok, caches) is step t's feed."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.models import build_transformer_decode_step
    from anakin_tpu_torch.quant import weight_only_quantize

    g = weight_only_quantize(build_transformer_decode_step(
        cfg, LLM_BATCH, params, kv_cache_dtype="int8", aligned_pos=not distinct,
        cache_update="rows" if distinct else "blend"), bits=4,
        packed=W4_PACKED)
    if variant is not None:
        for n in g.nodes.values():
            if n.op == "dense_w4":
                n.attrs.update(impl="pallas", variant=variant)
    net = ak.Net(g, precision="bf16", device="cuda")
    logits_e = g.outputs[0]
    cache_edges = [(f"cache_{kv}_{i}", g.nodes[f"dec_att_{i}"].outputs[1 + j])
                   for i in range(cfg.layers) for j, kv in enumerate("kv")]
    shape = (LLM_BATCH, cfg.kv_heads, cfg.max_seq, cfg.head_dim)
    caches0 = {k: torch.zeros(shape, dtype=torch.int8, device="cuda")
               for k, _ in cache_edges}
    base = torch.zeros((LLM_BATCH,), dtype=torch.int32, device="cuda")
    if distinct:
        last = cfg.max_seq - NEW - 1
        base = torch.clamp(torch.arange(LLM_BATCH, dtype=torch.int32,
                                        device="cuda")
                           * max(1, last // max(1, LLM_BATCH - 1)), max=last)

    def feed_at(t, tok, caches):
        return dict(caches, input=tok, pos=base + t)

    def run(steps):
        caches, tok = dict(caches0), torch.zeros(
            (LLM_BATCH, 1), dtype=torch.int32, device="cuda")
        for t in range(steps):
            out = net.prediction(feed_at(t, tok, caches))
            tok = torch.argmax(out[logits_e][:, 0, :], -1).to(torch.int32)[:, None]
            caches = {k: out[e] for k, e in cache_edges}
        return tok, out[logits_e], caches

    return g, net, run, feed_at


def ladder_path(report, key, tag, cfg, params, card, kernel, **ladder_kw):
    """Phases 6 and 12: build a w4 ladder, 32 chained greedy steps with
    the counts set to 0 just before and read just after (33 launches of
    `kernel` a step, nothing else), ms per token step, tokens/s, one
    profiled step.  Returns the counts and (net, feed, graph) of the last
    step's feed."""
    t0 = time.perf_counter()
    g, net, run, feed_at = w4_ladder(cfg, params, **ladder_kw)
    n_w4 = sum(n.op == "dense_w4" for n in g.nodes.values())
    if n_w4 != 2 * cfg.layers + 1:
        raise AssertionError(f"expected {2 * cfg.layers + 1} dense_w4 nodes, "
                             f"got {n_w4}")
    run(2)                                        # warm-up
    torch.cuda.synchronize()
    log(f"[{tag}] w4 graph, weights and warm-up: {time.perf_counter() - t0:.1f} s")
    reset_counts()
    tok, logits, caches = run(NEW)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[{tag}] launches in {NEW} decode steps: {counts}")
    if counts != dict(no_launches(), **{kernel: n_w4 * NEW}):
        raise AssertionError(f"expected {n_w4} {kernel} launches a step, "
                             f"got {counts}")
    if not torch.isfinite(logits.float()).all() or tok.min() < 0 \
            or tok.max() >= cfg.vocab:
        raise AssertionError("bad w4 decode output")
    step_ms = cuda_ms(lambda: run(NEW), iters=1, warmup=0, windows=3) / NEW
    res = dict(batch=LLM_BATCH, steps=NEW, precision="bf16", kv_cache="int8",
               dense_w4_nodes=n_w4, launches=counts, ms_per_step=step_ms,
               tokens_per_s=LLM_BATCH / step_ms * 1e3, **ladder_kw)
    log(f"[{tag}] w4 decode b{LLM_BATCH}: {step_ms:.3f} ms/token step, "
        f"{LLM_BATCH / step_ms * 1e3:.1f} tokens/s | {card}")
    feed = feed_at(NEW, tok, caches)
    res["profile"] = profile_step(lambda: net.prediction(feed), step_ms, tag)
    report[key] = res
    return counts, (net, feed, g)


def llm_path_b(report, cfg, params, card):
    """Phase 6: the aligned w4 decode ladder on matmul_w4 v1."""
    return ladder_path(report, "llm_b", "llm B", cfg, params, card,
                       "matmul_w4")[0]


def llm_path_b_v2(report, cfg, params, card):
    """Phase 12: the distinct-position ladder on matmul_w4 v2, then one
    step of the same configuration in v1 from the same feed."""
    import anakin_tpu_torch as ak

    counts, (net, feed, g) = ladder_path(
        report, "llm_b_v2", "llm B v2", cfg, params, card, "matmul_w4_v2",
        distinct=True, variant="v2")
    g1 = g.clone()
    for n in g1.nodes.values():
        if n.op == "dense_w4":
            n.attrs["variant"] = "v1"
    net1 = ak.Net(g1, precision="bf16", device="cuda")
    logits_e = g.outputs[0]
    # the step writes its cache rows in place: each net gets its own copy
    l2 = net.prediction({k: v.clone() for k, v in feed.items()})[logits_e]
    launches = read_counts()
    l1 = net1.prediction({k: v.clone() for k, v in feed.items()})[logits_e]
    torch.cuda.synchronize()
    v1_launches = read_counts()["matmul_w4"] - launches["matmul_w4"]
    if v1_launches != 2 * cfg.layers + 1:
        raise AssertionError(f"the v1 step launched matmul_w4 {v1_launches} times")
    f2, f1 = l2[:, 0].float().cpu(), l1[:, 0].float().cpu()
    scale = float(f1.abs().max())
    err = float((f2 - f1).abs().max())
    top2 = torch.topk(f1, 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    same = f2.argmax(-1) == f1.argmax(-1)
    decided = gap > LLM_TOL * scale
    log(f"[llm B v2] v2 vs v1, one step from the same feed: logits max diff "
        f"{err:.4g} ({err / scale:.3g} of the largest, tolerance {LLM_TOL}), "
        f"greedy tokens v2 {f2.argmax(-1).tolist()} v1 {f1.argmax(-1).tolist()},"
        f" top-2 gap {gap.tolist()}")
    if err > LLM_TOL * scale:
        raise AssertionError(f"v2 and v1 logits differ by {err}")
    if not bool(same[decided].all()):
        raise AssertionError("v2 and v1 greedy tokens differ where decided")
    report["llm_b_v2"]["vs_v1"] = dict(max_abs_diff=err, rel_to_max=err / scale,
                                       tokens_equal=same.tolist(),
                                       top2_gap=gap.tolist())
    return counts


F32_STEP_WINDOWS = 3  # replay windows of phase 6 b's timing


def llm_path_b_f32(report, cfg, params, card):
    """Phase 6 b: path B's w4 decode step in float32 (`Net(precision=
    "fp32")`, b8, int8 KV cache, the 1B-class weights quantized once for
    path B) on the float32 routes.  One eager step from random int8 caches
    at position PROMPT with every count set to 0 just before and read just
    after: 33 matmul_w4 launches, all on the float32 routes (matmul_w4_f32),
    nothing else; its launches' shapes recorded.  Then the step captured
    (`Net.compile`, the caches bound as static inputs): its logits equal
    the eager step's, and its replay timed.  Returns the counts and the
    launches by shape (attach_w4_calls)."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.models import build_transformer_decode_step
    from anakin_tpu_torch.quant import weight_only_quantize

    t0 = time.perf_counter()
    g = weight_only_quantize(build_transformer_decode_step(
        cfg, LLM_BATCH, params, kv_cache_dtype="int8", aligned_pos=True),
        bits=4, packed=W4_PACKED)
    n_w4 = sum(n.op == "dense_w4" for n in g.nodes.values())
    net = ak.Net(g, precision="fp32", device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    shape = (LLM_BATCH, cfg.kv_heads, cfg.max_seq, cfg.head_dim)
    base = {k: torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)
            for k in g.inputs if k.startswith("cache_")}
    tok = torch.randint(0, cfg.vocab, (LLM_BATCH, 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    pos = torch.full((LLM_BATCH,), PROMPT, dtype=torch.int32, device="cuda")
    logits_e = g.outputs[0]
    net.prediction(dict({k: v.clone() for k, v in base.items()}, input=tok,
                        pos=pos))  # warm-up
    eager_c = {k: v.clone() for k, v in base.items()}
    tap = launched_llm_shapes()
    torch.cuda.synchronize()
    reset_counts()
    with tap:
        want = net.prediction(dict(eager_c, input=tok, pos=pos))[logits_e]
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[llm B fp32] launches in one float32 w4 decode step: {counts}")
    if counts != dict(no_launches(), matmul_w4=n_w4, matmul_w4_f32=n_w4):
        raise AssertionError(f"expected {n_w4} matmul_w4 launches on the "
                             f"float32 routes, got {counts}")
    if not torch.isfinite(want).all():
        raise AssertionError("non-finite float32 w4 step logits")
    eager_ms = cuda_ms(lambda: net.prediction(dict(
        {k: v.clone() for k, v in base.items()}, input=tok, pos=pos)),
        iters=3, windows=F32_STEP_WINDOWS)
    graph_c = {k: v.clone() for k, v in base.items()}
    step = net.compile(dict(graph_c, input=tok, pos=pos), static=graph_c)
    got = step({"input": tok, "pos": pos})[logits_e]
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    # each replay writes the same cache rows again
    ms = cuda_ms(lambda: step({"input": tok, "pos": pos}), iters=10,
                 windows=F32_STEP_WINDOWS)
    log(f"[llm B fp32] float32 w4 decode step b{LLM_BATCH} (int8 KV, "
        f"{cfg.layers} layers): captured {ms:.3f} ms (replay), eager "
        f"{eager_ms:.3f} ms; captured logits equal to the eager step's: "
        f"{same}; {n_w4} matmul_w4 launches on "
        f"{sorted(set(route_of_key(k) for k in tap.w4_calls))} "
        f"({time.perf_counter() - t0:.1f} s) | {card}")
    if not same:
        raise AssertionError("the captured float32 w4 step differs from the "
                             "eager step")
    report["llm_b_f32"] = dict(
        batch=LLM_BATCH, precision="fp32", kv_cache="int8", launches=counts,
        ms_per_step_captured=ms, ms_per_step_eager=eager_ms,
        captured_equals_eager=same,
        launch_shapes=[[list(k), n] for k, n in sorted(tap.w4_calls.items())])
    return counts, dict(tap.w4_calls)


def route_of_key(key):
    """The route of a launched_llm_shapes matmul_w4 key."""
    M, K, N, G, dt, bs, _ = key
    return w4_route(M, K, N, G, getattr(torch, dt.split(".")[-1]), bs)[0]


def _flash_bound(q, k, n_pairs, segs):
    """max(bytes / HBM rate, operations / peak): bf16 at the bf16 tensor-core
    rate; float32 as the kernel computes it, three TF32 products a product
    (the split) at the TF32 tensor-core rate."""
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    if segs is not None:
        nbytes += 4 * (segs.numel() * 2)
    ops = 4 * q.shape[1] * q.shape[3] * n_pairs
    if q.dtype == torch.bfloat16:
        t_o = ops / PEAK_BF16_OPS * 1e3
    else:
        t_o = 3 * ops / PEAK_TF32_OPS * 1e3
    t_b = nbytes / PEAK_BYTES * 1e3
    return (t_o, "operations") if t_o >= t_b else (t_b, "bytes")


def check_flash(B, H, Hkv, S, D, dtype, causal, lengths, gen, calls,
                timed=True, Sk=None):
    """flash_attention against mha_reference on the card; tolerance as in
    csrc/flash_attention.cu: float32 |d| <= 3e-5 max|v|; bf16 |d| <=
    2^-7 |want| + 3e-5 max|v|.  `timed=False` skips the timings (None).
    `Sk` (default S) gives k and v another length: cross-attention.  The
    library call is SDPA on the kv heads repeated, with
    `torch.backends.cuda.matmul.allow_tf32` False.  Float32 rows are
    named flash_attention_f32 (the kernels line's entry of that route).
    `route` is the kernel's route at the shape and `block_rows` the query
    rows a block of it holds."""
    import torch.nn.functional as F
    from anakin_tpu_torch.kernels.flash_attention import (flash_attention,
                                                          mha_reference, route)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    Sk = S if Sk is None else Sk
    q, k, v = rnd(B, H, S, D), rnd(B, Hkv, Sk, D), rnd(B, Hkv, Sk, D)
    segs = None
    allowed = torch.ones((B, S, Sk), dtype=torch.bool, device="cuda")
    if lengths is not None:
        t = torch.arange(S, device="cuda")
        segs = (t[None] >= torch.tensor(lengths, device="cuda")[:, None]).to(torch.int32)
        allowed &= segs[:, :, None] == segs[:, None, :]
    if causal:
        allowed &= (torch.arange(Sk, device="cuda")[None, :]
                    <= torch.arange(S, device="cuda")[:, None])[None]
    n_pairs = int(allowed.sum())
    launches = (flash_attention.launches, flash_attention.launches_f32,
                flash_attention.launches_wgmma)
    got = flash_attention(q, k, v, segs, segs, causal=causal)
    want = mha_reference(q, k, v, segs, segs, causal=causal)
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs()
    vmax = float(v.float().abs().max())
    tol = 3e-5 * vmax + (2.0 ** -7 * want.float().abs() if dtype == torch.bfloat16
                         else 0.0)
    ok = bool((d <= tol).all())
    ms = plain_ms = library_ms = None
    if timed:
        iters = 20 if S <= 512 else 5
        ms = graph_ms(lambda: flash_attention(q, k, v, segs, segs,
                                              causal=causal), iters=iters)
        plain_ms = graph_ms(lambda: mha_reference(q, k, v, segs, segs,
                                                  causal=causal), iters=2)
        kr = torch.repeat_interleave(k, H // Hkv, dim=1)
        vr = torch.repeat_interleave(v, H // Hkv, dim=1)
        if lengths is None:
            lib = lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                         is_causal=causal)
        else:
            mask = allowed[:, None]
            lib = lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                         attn_mask=mask)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            library_ms = graph_ms(lib, iters=iters)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    (flash_attention.launches, flash_attention.launches_f32,
     flash_attention.launches_wgmma) = launches
    bms, by = _flash_bound(q, k, n_pairs, segs)
    flash_route, block_rows = route(dtype, B, H, Hkv, S, D)
    return dict(kernel=("flash_attention" if dtype == torch.bfloat16
                        else "flash_attention_f32"),
                shape=[B, H, Hkv, S, D], sk=Sk, route=flash_route,
                block_rows=block_rows,
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


def w4_route(M, K, N, G, dtype, bf16_scales):
    """(route, splits of K) a matmul_w4 launch takes, as the kernel's
    `ak_matmul_w4_route` names it; (None, workspace splits) for a tree
    whose kernel names no route."""
    import importlib

    mw = importlib.import_module("anakin_tpu_torch.kernels.matmul_w4")
    sdt = torch.bfloat16 if bf16_scales else torch.float32
    if hasattr(mw, "route"):
        return mw.route(M, N, K, G, dtype, sdt)
    return None, mw._lib().ak_matmul_w4_splits(
        M, N, K, G, int(dtype == torch.bfloat16) | 2 * int(bf16_scales))


W4_F32_ROUTES = ("small_tf32", "wgmma_tf32")  # float32 x, TF32 tensor cores


def w4_kernel_name(route, variant):
    """The kernels line's entry a matmul_w4 row counts for: the M > 16
    wgmma route and the float32 routes have one each of their own, for
    both variants."""
    if route == "wgmma":
        return "matmul_w4_wgmma"
    if route in W4_F32_ROUTES:
        return "matmul_w4_f32"
    return "matmul_w4_v2" if variant == "v2" else "matmul_w4"


def check_w4(M, K, N, G, dtype, gen, calls, variant="v1", bf16_scales=False,
             timed=True):
    """matmul_w4 (`variant` v1 or v2) against matmul_w4_plain on the card;
    `bf16_scales` hands the scales over in bf16, as a bf16 net does.
    Tolerance: the two sum the same float32 products in another order,
    and any order is within K * 2^-24 * (|x| @ |W|) of the exact sum, so
    |d| <= 2 K 2^-24 (|x| @ |W|).  A v2 row also times v1 on the
    same inputs and counts the dequantized weights where the two differ.
    Each row names the kernel's route and its splits of K (w4_route).
    `timed=False` skips the timings and the yardsticks (None)."""
    from anakin_tpu_torch.kernels.matmul_w4 import (_lib, matmul_w4,
                                                    matmul_w4_plain, unpack_w4,
                                                    unpack_w4_v2)
    from anakin_tpu_torch.quant.quantize import _w4_group_quantize

    rng = np.random.default_rng(M * 7 + K + N)
    p_np, s_np, g = _w4_group_quantize(
        rng.normal(0.0, K ** -0.5, (K, N)).astype(np.float32), G)
    packed, scales = torch.from_numpy(p_np).cuda(), torch.from_numpy(s_np).cuda()
    if bf16_scales:
        scales = scales.to(torch.bfloat16)
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    launches = matmul_w4.launches, matmul_w4.launches_v2
    got = matmul_w4(x, packed, scales, group=g, variant=variant)
    want = matmul_w4_plain(x, packed, scales, group=g, variant=variant)
    w = (unpack_w4_v2 if variant == "v2" else unpack_w4)(packed, scales, g, dtype)
    mag = x.float().abs() @ w.float().abs()
    d = (got - want).abs()
    ok = bool((d <= 2 * K * 2.0 ** -24 * mag).all())
    # the splits of K the launch took (> 1: in a cluster's shared memory
    # for bf16 x, through the workspace and sum_splits otherwise)
    route, splits = w4_route(M, K, N, g, dtype, bf16_scales)
    counted = getattr(matmul_w4, "launches_wgmma", None)
    kernel = w4_kernel_name(route, variant)
    if not timed:
        matmul_w4.launches, matmul_w4.launches_v2 = launches
        if counted is not None:
            matmul_w4.launches_wgmma = counted
        return dict(kernel=kernel, variant=variant, route=route,
                    shape=[M, K, N, g], dtype=str(dtype).split(".")[-1],
                    bf16_scales=bf16_scales, splits=splits, ok=ok,
                    max_abs_err=float(d.max()),
                    max_rel_to_mag=float((d / mag).max()), ms=None,
                    calls_per_run=calls)
    # enough copies of the weights that every call reads them from HBM
    n_copies = max(1, -(-100 * 2 ** 20 // (packed.numel() + 4 * scales.numel())))
    copies = [(x, packed.clone(), scales.clone()) for _ in range(n_copies)]
    ms = graph_ms(rotating(lambda *a: matmul_w4(*a, group=g, variant=variant),
                           copies), iters=2 * n_copies)
    plain_ms = graph_ms(rotating(lambda *a: matmul_w4_plain(
        *a, group=g, variant=variant), copies), iters=n_copies)
    v1_ms = weights_differ = None
    if variant == "v2":
        v1_ms = graph_ms(rotating(lambda *a: matmul_w4(*a, group=g), copies),
                         iters=2 * n_copies)
        weights_differ = int((unpack_w4(packed, scales, g, dtype) != w).sum())
    matmul_w4.launches, matmul_w4.launches_v2 = launches
    if counted is not None:
        matmul_w4.launches_wgmma = counted
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
    # at prefill shapes, the dequant done each call beside the product: the
    # yardstick of the M > 16 route
    unpack = unpack_w4_v2 if variant == "v2" else unpack_w4
    dequant_then_mm_ms = None if M <= 16 else graph_ms(rotating(
        lambda x_, p_, s_: torch.matmul(x_, unpack(p_, s_, g, dtype)), copies),
        iters=n_copies)
    xb = x.element_size()
    nbytes = (K // 2 * N + (K // g) * N * scales.element_size() + M * K * xb
              + M * N * 4)
    ops = 2 * M * N * K
    if route in W4_F32_ROUTES:  # two TF32 products a float32 product
        t_o = 2 * ops / PEAK_TF32_OPS * 1e3
    else:  # bf16 on the tensor cores; float32 w4_rows on the CUDA cores
        t_o = ops / (PEAK_BF16_OPS if dtype == torch.bfloat16 else PEAK_F32_OPS) * 1e3
    t_b = nbytes / PEAK_BYTES * 1e3
    bms, by = (t_o, "operations") if t_o >= t_b else (t_b, "bytes")
    return dict(kernel=kernel, variant=variant, route=route,
                shape=[M, K, N, g], dtype=str(dtype).split(".")[-1],
                bf16_scales=bf16_scales, splits=splits, ok=ok,
                max_abs_err=float(d.max()), max_rel_to_mag=float((d / mag).max()),
                ms=ms, plain_ms=plain_ms, v1_ms=v1_ms,
                weights_differ_from_v1=weights_differ,
                library_ms=library_ms, library_rel_err=lib_err, library_none_reason=why,
                dequantized_matmul_ms=dequant_mm_ms,
                dequant_then_matmul_ms=dequant_then_mm_ms, bound_ms=bms, bound_by=by,
                calls_per_run=calls)


def admission_buckets(cfg):
    """The bucket lengths phase 15's prompts (SCHED_LENGTHS) are admitted
    at."""
    from anakin_tpu_torch.runtime.generate import prefill_bucket

    return sorted({prefill_bucket(P, cfg.max_seq) for P in SCHED_LENGTHS})


def admission_w4_cases(cfg):
    """matmul_w4 at phase 15's bucket admissions: M = 8 L, both MLP
    projections, the scales in bf16 as the scheduler's prefill hands them
    over (M > 16: the wgmma route; bucket 64's 8192 -> 2048 product is the
    one whose grid is short enough to split K)."""
    E, F_ = cfg.embed, 4 * cfg.embed
    return [(LLM_BATCH * L, k, n, 128, torch.bfloat16, True, 0)
            for L in admission_buckets(cfg) for k, n in ((E, F_), (F_, E))]


def wgmma_edge_w4_cases(cfg):
    """The edges of the M > 16 route, checked untimed: one row past the
    M <= 16 route, a partial 128-row tile, a ragged and unaligned N (the
    byte-by-byte loads), K = G = 128 (two chunks), G = 64 (one chunk a
    group), each with bf16 and float32 scales where the dequant differs;
    and the tensor-parallel halves (N / 2 and K / 2 of the two MLP
    projections) at buckets 64 and 512."""
    E, F_ = cfg.embed, 4 * cfg.embed
    bf16 = torch.bfloat16
    return [  # (M, K, N, G, dtype, scales in bf16, calls)
        *[(m, E, F_, 128, bf16, bs, 0) for m in (17, 130) for bs in (True, False)],
        (130, F_, E, 128, bf16, False, 0),
        *[(130, E, 1003, 128, bf16, bs, 0) for bs in (True, False)],
        (4096, 128, F_, 128, bf16, True, 0),
        (4096, E, F_, 64, bf16, False, 0),
        *[(LLM_BATCH * L, k, n, 128, bf16, True, 0) for L in (64, 512)
          for k, n in ((E, F_ // 2), (F_ // 2, E))],
    ]


def log_w4_row(r, calls, tag="matmul_w4"):
    """One matmul_w4 row of phases 7 and 13: its route and splits of K,
    its error, and, where timed, its ms beside its share of the bound, its
    plain version and its yardsticks."""
    m, k, n, _ = r["shape"]
    line = (f"[kernel] {tag} {m}x{k}->{n} {r['dtype']} scales "
            f"{'bf16' if r['bf16_scales'] else 'float32'} x{calls} "
            f"route={r['route']} splits={r['splits']} "
            f"err={r['max_abs_err']:.3g} ({r['max_rel_to_mag']:.2g} of "
            f"|x|@|W|) ok={r['ok']}")
    if r["ms"] is not None:
        lib = ("none: " + r["library_none_reason"] if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        line += (f" ms={r['ms']:.4f} ({r['bound_ms'] / r['ms']:.1%} of the "
                 f"bound) plain={r['plain_ms']:.3f}"
                 + ("" if r["v1_ms"] is None else f" v1={r['v1_ms']:.4f}")
                 + f" int4pack_mm={lib} dequantized-"
                 f"{'bf16' if r['dtype'] == 'bfloat16' else 'float32'}-matmul="
                 f"{r['dequantized_matmul_ms']:.4f}"
                 + ("" if r["dequant_then_matmul_ms"] is None else
                    f" dequant+matmul={r['dequant_then_matmul_ms']:.4f}")
                 + f" bound={r['bound_ms']:.4f} ({r['bound_by']})")
        if r["weights_differ_from_v1"] is not None:
            line += (f" weights differing from v1: "
                     f"{r['weights_differ_from_v1']} of {k * n}")
    log(line)


def attach_w4_calls(results, w4_calls, kernel, run):
    """Each launch shape (launched_llm_shapes keys) of `kernel` in a
    counted run (phase 15's round for matmul_w4_wgmma, phase 6 b's step
    for matmul_w4_f32) sets calls_per_run on phase 7's timed row of that
    shape, which the kernels line's entry then sums; a shape without a
    timed row fails."""
    for (M, K, N, G, dt, bs, variant), n in w4_calls.items():
        rows = [r for r in results if r["kernel"] == kernel
                and r["shape"] == [M, K, N, G] and r["ms"] is not None
                and r["dtype"] == dt.split(".")[-1] and r["bf16_scales"] == bs
                and r["variant"] == variant]
        if not rows:
            raise AssertionError(f"no timed matmul_w4 row for {run}'s "
                                 f"launch {M}x{K}->{N} G{G} {dt} {variant}")
        rows[0]["calls_per_run"] = n


def attach_tuner_calls(results, n):
    """Phase 17's count of float32 flash launches in one tuning sets
    calls_per_run on phase 7's row at the tuner's shape, which the kernels
    line's flash_attention_f32 entry then sums."""
    from anakin_tpu_torch.models import TransformerConfig

    lc = TransformerConfig(**LONGCTX_CFG)
    shape = [LONGCTX_BATCH, lc.heads, lc.kv_heads, lc.max_seq, lc.head_dim]
    rows = [r for r in results if r["kernel"] == "flash_attention_f32"
            and r["shape"] == shape and r["causal"] and r["ms"] is not None]
    if not rows:
        raise AssertionError(f"no timed float32 flash row at the tuner's "
                             f"shape {shape}")
    rows[0]["calls_per_run"] = n


def w4_route_wanted(r):
    """The route a matmul_w4 row's shape asks for: with a group that is a
    multiple of 32, bf16 x on small (M <= 16) or wgmma, float32 x on
    small_tf32 or wgmma_tf32; rows for any other group."""
    M, G = r["shape"][0], r["shape"][3]
    if G % 32:
        return "rows"
    route = "small" if M <= 16 else "wgmma"
    return route if r["dtype"] == "bfloat16" else route + "_tf32"


def flash_route_wanted(r):
    """The route a flash row's shape asks for: float32 on flash_tf32; bf16
    on flash_wgmma where D is whole 64-column slabs (64, 128, 256), else on
    flash_bf16 (mma.sync)."""
    if r["dtype"] == "float32":
        return "flash_tf32"
    return "flash_wgmma" if r["shape"][4] in (64, 128, 256) else "flash_bf16"


def check_flash_routes(results):
    """Every flash_attention row took the route its shape asks for."""
    wrong = [r for r in results if r["kernel"].startswith("flash_attention")
             and r["route"] != flash_route_wanted(r)]
    if wrong:
        raise AssertionError(f"flash_attention rows off their route: {wrong}")


def wgmma_flash_launches():
    """flash_attention's launches on its flash_wgmma route so far."""
    from anakin_tpu_torch.kernels.flash_attention import flash_attention

    return flash_attention.launches_wgmma


def require_wgmma_flash(where, counts, wgmma):
    """Every bf16 flash launch of a counted run (`counts`) went through
    flash_wgmma (`wgmma` of them did): the path's head dims are the route's."""
    bf16 = counts["flash_attention"] - counts["flash_attention_f32"]
    if wgmma != bf16:
        raise AssertionError(f"{where}: {bf16} bf16 flash launches, {wgmma} "
                             f"of them on flash_wgmma")


def check_w4_routes(results):
    """Every matmul_w4 row took the route its shape asks for."""
    wrong = [r for r in results if r["kernel"].startswith("matmul_w4")
             and r["route"] != w4_route_wanted(r)]
    if wrong:
        raise AssertionError(f"matmul_w4 rows off their route: {wrong}")


# every group the quantizer writes, beside the path's 128: 32 (K 2048), K
# itself (K = G = 96), 96 over K 1920, at the decode shape (M 8, N 8192)
# and at M 4096 (the half-chunk routes: small, wgmma, small_tf32,
# wgmma_tf32), bf16 x with bf16 scales as a bf16 net hands them over, and
# float32 x
W4_GROUP_CASES = [  # (M, K, N, G, dtype, scales in bf16, calls per run)
    (LLM_BATCH, 2048, 8192, 128, torch.bfloat16, True, 0),
    (LLM_BATCH, 2048, 8192, 32, torch.bfloat16, True, 0),
    (LLM_BATCH, 96, 8192, 96, torch.bfloat16, True, 0),
    (LLM_BATCH, 1920, 8192, 96, torch.bfloat16, True, 0),
    (LLM_BATCH, 2048, 8192, 32, torch.float32, False, 0),
    (4096, 2048, 8192, 32, torch.bfloat16, True, 0),
    (4096, 1920, 8192, 96, torch.bfloat16, True, 0),
    (4096, 2048, 8192, 32, torch.float32, False, 0),
]


def route_edge_w4_cases(cfg, f32=True):
    """The edges of the half-chunk and float32 routes, checked untimed:
    with float32 x (`f32`; one kernel serves v1 and v2 there) M 1, 16, 17
    and 130 with bf16 and float32 scales, a ragged and unaligned N (the
    byte-by-byte copies), K = G = 128 and G 64 on each float32 route, the
    tensor-parallel halves (N / 2 and K / 2 of the two MLP projections) of
    a float32 step and of a bucket-512 prefill; with both dtypes a second
    half-chunk past K (K = G = 96, K 1920 at G 96 and M > 16), G 32 through
    the byte-by-byte copies, and groups the chunked routes cannot take (G
    48, K = G = 80) on w4_rows."""
    E, F_ = cfg.embed, 4 * cfg.embed
    f32t, bf16 = torch.float32, torch.bfloat16
    rows = [  # (M, K, N, G, dtype, scales in bf16, calls)
        (130, 96, F_, 96, bf16, True, 0),
        (130, 1920, F_, 96, bf16, False, 0),
        (8, E, 1003, 32, bf16, True, 0),
        (130, E, 1003, 32, bf16, False, 0),
        (8, 96, 520, 48, bf16, True, 0),
        (130, 80, 520, 80, bf16, False, 0),
    ]
    if f32:
        rows += [
            *[(m, E, F_, 128, f32t, bs, 0) for m in (1, 16, 17, 130)
              for bs in (True, False)],
            (8, E, 1003, 128, f32t, False, 0),
            (130, E, 1003, 128, f32t, True, 0),
            (8, 128, F_, 128, f32t, True, 0),
            (4096, 128, F_, 128, f32t, False, 0),
            (8, E, F_, 64, f32t, False, 0),
            (4096, E, F_, 64, f32t, True, 0),
            *[(m, k, n, 128, f32t, False, 0) for m in (LLM_BATCH, LLM_BATCH * 512)
              for k, n in ((E, F_ // 2), (F_ // 2, E))],
            (8, 96, F_, 96, f32t, False, 0),
            (130, 96, F_, 96, f32t, True, 0),
            (130, 1920, F_, 96, f32t, False, 0),
            (8, E, 1003, 32, f32t, True, 0),
            (130, E, 1003, 32, f32t, False, 0),
            (8, 96, 520, 48, f32t, False, 0),
            (130, 80, 520, 80, f32t, True, 0),
        ]
    return rows


def llm_kernels(report, cfg):
    """Phase 7: both LLM kernels against their plain versions."""
    from anakin_tpu_torch.kernels import autotune
    from anakin_tpu_torch.models import TransformerConfig

    E, F_ = cfg.embed, 4 * cfg.embed
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    B, H, Hkv, D = LLM_BATCH, cfg.heads, cfg.kv_heads, cfg.head_dim
    flash_cases = [  # (B, H, Hkv, S, D, dtype, causal, lengths, calls per generate)
        (B, H, Hkv, PROMPT, D, torch.bfloat16, True, None, cfg.layers),
        (2, H, Hkv, 300, D, torch.bfloat16, True, [300, 173], 0),
        (2, H, Hkv, 300, D, torch.float32, True, [300, 173], 0),
        (B, H, Hkv, PROMPT, D, torch.float32, True, None, 0),
        (B, H, Hkv, 2048, D, torch.bfloat16, True, None, 0),
        # the bf16 kernel's other paths: one query head per kv head (128-row
        # blocks of one head), four per kv head, an odd group, other head
        # dims, S = 128 k + 1 (a one-row last q tile and kv tile), no causal
        # mask, segment ids; at b8 with two consumer warpgroups a block
        # (flash_wgmma; flash_bf16: two row tiles a warp), at b2 with one
        # (the grid would hold fewer blocks than SMs)
        (B, H, H, PROMPT, D, torch.bfloat16, True, None, 0),
        (B, H, 4, PROMPT, D, torch.bfloat16, True, None, 0),
        (B, H, Hkv, PROMPT, 64, torch.bfloat16, True, None, 0),
        (B, H, Hkv, 257, D, torch.bfloat16, False, None, 0),
        (B, H, Hkv, PROMPT, D, torch.bfloat16, True,
         [512, 300, 511, 64, 1, 257, 448, 200], 0),
        (2, H, H, PROMPT, D, torch.bfloat16, True, None, 0),
        (2, 6, 2, 129, 32, torch.bfloat16, True, None, 0),
        (2, H, Hkv, 385, D, torch.bfloat16, True, None, 0),
        # the head dims of public configs beside 32, 64 and 128: 80 (an odd
        # number of 16-wide k steps) and 96 on flash_bf16, 256 on flash_wgmma
        # (one consumer a block); ragged lengths
        (B, H, Hkv, PROMPT, 80, torch.bfloat16, True, None, 0),
        (B, H, Hkv, PROMPT, 96, torch.bfloat16, True, None, 0),
        (B, H, Hkv, PROMPT, 256, torch.bfloat16, True, None, 0),
        (2, H, Hkv, 300, 80, torch.bfloat16, True, [300, 173], 0),
        (2, H, Hkv, 300, 256, torch.bfloat16, False, [300, 173], 0),
        (2, H, Hkv, 300, 96, torch.float32, True, [300, 173], 0),
        # phase 15's bucket admissions from 512 on (512 is the path's row)
        *[(B, H, Hkv, L, D, torch.bfloat16, True, None, 0)
          for L in (768, 1024, 1536)],
        # flash_wgmma at D 64 with ragged lengths (one consumer a block),
        # and non-causal cross-attention (Sk 700 below)
        (2, H, Hkv, 300, 64, torch.bfloat16, True, [300, 173], 0),
        (2, H, Hkv, 300, D, torch.bfloat16, False, None, 0),
    ]
    sk = {len(flash_cases) - 1: 700}  # row index -> Sk
    # the shapes of phases 16 and 17, which the kernels line does not sum
    # (its unit is path A's generate): (row, where, launches there)
    dH = SPEC_DRAFT["heads"]
    lc = TransformerConfig(**LONGCTX_CFG)
    elsewhere = [
        ((1, H, Hkv, PROMPT, D, torch.bfloat16, True, None, 0),
         "a speculative generate's target prefill", cfg.layers),
        ((1, dH, SPEC_DRAFT["kv_heads"], PROMPT, SPEC_DRAFT["embed"] // dH,
          torch.bfloat16, True, None, 0),
         "a speculative generate's draft prefill", SPEC_DRAFT["layers"]),
        ((1, H, Hkv, PROMPT, D, torch.float32, True, None, 0),
         "a draft = target generate's two prefills", 2 * SPEC_SMALL_LAYERS),
        ((LONGCTX_BATCH, lc.heads, lc.kv_heads, lc.max_seq, lc.head_dim,
          torch.bfloat16, True, None, 0),
         "a tuned long-context forward (if the tuner takes flash)", lc.layers),
        ((LONGCTX_BATCH, lc.heads, lc.kv_heads, lc.max_seq, lc.head_dim,
          torch.float32, True, None, 0),
         "a tuning of phase 17's key (the flash candidate's calls)",
         1 + autotune._WINDOWS * autotune._CALLS),
    ]
    where = {len(flash_cases) + i: (w, n)
             for i, (_, w, n) in enumerate(elsewhere)}
    flash_cases += [row for row, _, _ in elsewhere]
    # the float32 route at every head dim it takes beside 96 and 128 (D 32
    # with an odd group and a ragged tile, D 64 with two row tiles a warp,
    # D 80 with segment ids), and non-causal cross-attention (Sk != Sq)
    sk[len(flash_cases) + 3] = 700
    flash_cases += [
        (2, 6, 2, 129, 32, torch.float32, True, None, 0),
        (B, H, Hkv, PROMPT, 64, torch.float32, True, None, 0),
        (2, H, Hkv, 300, 80, torch.float32, True, [300, 173], 0),
        (2, H, Hkv, 300, D, torch.float32, False, None, 0),
    ]
    bf16, f32 = torch.bfloat16, torch.float32
    w4_cases = [  # (M, K, N, G, dtype, scales in bf16, calls per 32 steps)
        # the path: the bf16 net hands its scales over in bf16
        (B, E, F_, 128, bf16, True, cfg.layers * NEW),
        (B, F_, E, 128, bf16, True, cfg.layers * NEW),
        (B, E, cfg.vocab, 128, bf16, True, NEW),
        # the same with float32 scales
        (B, E, F_, 128, bf16, False, 0),
        (B, F_, E, 128, bf16, False, 0),
        (B, E, cfg.vocab, 128, bf16, False, 0),
        # the edges of the M <= 16 route: one row, two n8 tiles, a ragged M;
        # N not a multiple of 16 (the byte-by-byte path); one group, one split
        (1, E, F_, 128, bf16, True, 0),
        (16, E, F_, 128, bf16, True, 0),
        (16, E, F_, 128, bf16, False, 0),
        (5, E, F_, 128, bf16, False, 0),
        (B, E, 1003, 128, bf16, False, 0),
        (B, 128, F_, 128, bf16, True, 0),
        # the M > 16 route with float32 scales (v1's float32 dequant)
        (4096, E, F_, 128, bf16, False, 0),
        # float32 x: phase 6 b's step (its three shapes; the step's launches
        # set their calls), M 5 with bf16 scales, a prefill's M 4096
        (B, E, F_, 128, f32, False, 0),
        (B, F_, E, 128, f32, False, 0),
        (B, E, cfg.vocab, 128, f32, False, 0),
        (5, E, F_, 128, f32, True, 0),
        (4096, E, F_, 128, f32, False, 0),
        # the M > 16 route at the bucket admissions of phases 15 and 23,
        # M = 8 L, scales in bf16: bucket 64 (8192 -> 2048 splits K in a
        # cluster) to the largest, 1536; bucket 512 is M 4096
        *admission_w4_cases(cfg),
    ] + W4_GROUP_CASES
    results = []
    for i, (b, h, hkv, s, d, dt, causal, lens, calls) in enumerate(flash_cases):
        t0 = time.perf_counter()
        r = check_flash(b, h, hkv, s, d, dt, causal, lens, gen, calls,
                        Sk=sk.get(i))
        if i in where:
            r["elsewhere"] = dict(zip(("path", "launches"), where[i]))
        results.append(r)
        log(f"[kernel] flash_attention {r['shape']} {r['dtype']} causal={causal}"
            f" lengths={lens}" + (f" Sk={r['sk']}" if i in sk else "")
            + f" x{calls} route={r['route']} rows={r['block_rows']}"
            + (f" (x{where[i][1]} in {where[i][0]})" if i in where else "")
            + f" err={r['max_abs_err']:.3g} ok={r['ok']} "
            f"ms={r['ms']:.4f} plain={r['plain_ms']:.3f} "
            f"sdpa={r['library_ms']:.4f} ({r['library_ms'] / r['ms']:.2f}x this) "
            f"bound={r['bound_ms']:.4f} ({r['bound_by']}; "
            f"{r['bound_ms'] / r['ms']:.1%} of it) ({time.perf_counter() - t0:.1f} s)")
    for m, k, n, grp, dt, bs, calls in w4_cases:
        results.append(check_w4(m, k, n, grp, dt, gen, calls, bf16_scales=bs))
        log_w4_row(results[-1], calls)
    for m, k, n, grp, dt, bs, calls in (wgmma_edge_w4_cases(cfg)
                                        + route_edge_w4_cases(cfg)):
        results.append(check_w4(m, k, n, grp, dt, gen, calls, bf16_scales=bs,
                                timed=False))
        log_w4_row(results[-1], calls)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel differs from its plain version: {bad}")
    check_flash_routes(results)
    check_w4_routes(results)
    split = [r for r in results if r["kernel"].startswith("matmul_w4")
             and r["shape"][:3] == [LLM_BATCH * 64, F_, E] and r["dtype"] == "bfloat16"]
    if not split or split[0]["splits"] < 2:
        raise AssertionError(f"bucket 64's 8192 -> 2048 product did not split "
                             f"K: {split}")
    report["llm_kernel_configs"] = results
    return results


def w4_v2_kernels(report, cfg):
    """Phase 13: matmul_w4 v2 against its plain version."""
    E, F_, B = cfg.embed, 4 * cfg.embed, LLM_BATCH
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (M, K, N, G, dtype, scales in bf16, calls per 32 steps)
        (B, E, F_, 128, bf16, True, cfg.layers * NEW),
        (B, F_, E, 128, bf16, True, cfg.layers * NEW),
        (B, E, cfg.vocab, 128, bf16, True, NEW),
        (B, F_, E, 128, f32, False, 0),
        (5, E, F_, 128, f32, True, 0),
        (4096, E, F_, 128, f32, False, 0),
        (4096, E, F_, 128, bf16, True, 0),
        # v2 with float32 scales at M > 16, where its weights differ from
        # v1's (phase 7 holds v1 at the same shape)
        (4096, E, F_, 128, bf16, False, 0),
        (B, E, F_, 128, bf16, False, 0),
        # the edges of the M <= 16 route, as in phase 7
        (1, E, F_, 128, bf16, True, 0),
        (16, E, F_, 128, bf16, True, 0),
        (B, E, 1003, 128, bf16, True, 0),
        (B, 128, F_, 128, bf16, True, 0),
    ] + W4_GROUP_CASES
    results = []
    for m, k, n, grp, dt, bs, calls in cases:
        results.append(check_w4(m, k, n, grp, dt, gen, calls, variant="v2",
                                bf16_scales=bs))
        log_w4_row(results[-1], calls, "matmul_w4_v2")
    for m, k, n, grp, dt, bs, calls in (wgmma_edge_w4_cases(cfg)
                                        + route_edge_w4_cases(cfg, f32=False)):
        results.append(check_w4(m, k, n, grp, dt, gen, calls, variant="v2",
                                bf16_scales=bs, timed=False))
        log_w4_row(results[-1], calls, "matmul_w4_v2")
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel differs from its plain version: {bad}")
    check_w4_routes(results)
    report["w4_v2_kernel_configs"] = results
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
    # the same step in float32: on the card the float32 routes
    reset_counts()
    df = ak.Net(g4, "fp32", device="cuda").prediction(
        {k: v.clone().cuda() for k, v in feed.items()})[g4.outputs[0]]
    torch.cuda.synchronize()
    if read_counts()["matmul_w4_f32"] != 2 * cfg.layers + 1:
        raise AssertionError("the card's float32 w4 step did not run the "
                             "float32 routes")
    dcf = ak.Net(g4, "fp32", device="cpu").prediction(
        {k: v.clone() for k, v in feed.items()})[g4.outputs[0]]

    res = {}
    for name, g_, c_, tol in (("prefill", lg, lc, LLM_TOL),
                              ("w4_step", dg, dc, LLM_TOL),
                              ("w4_step_fp32", df, dcf, F32_W4_TOL)):
        gf, cf = g_[:, 0].float().cpu(), c_[:, 0].float()
        scale = float(cf.abs().max())
        err = float((gf - cf).abs().max())
        top2 = torch.topk(cf, 2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        same = gf.argmax(-1) == cf.argmax(-1)
        decided = gap > tol * scale
        log(f"[cpu/gpu llm] {name}: logits max diff {err:.4g} "
            f"({err / scale:.3g} of the largest, tolerance {tol}), greedy "
            f"tokens gpu {gf.argmax(-1).tolist()} cpu {cf.argmax(-1).tolist()}, "
            f"top-2 gap {gap.tolist()}")
        if err > tol * scale:
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


def check_dw(cfg, gen, misaligned=False, timed=True):
    """depthwise3x3_int8 against its plain version on the card: int8
    outputs equal, float outputs within rtol 1e-6.  Times from CUDA-graph
    replay with x rotated through >= 100 MB of copies, beside the bound,
    the plain version and, as context only, cuDNN's bf16 grouped conv on
    the same shapes (not the same function: PyTorch has no int8 depthwise
    conv on CUDA).  `timed=False` checks only."""
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
    if not timed:
        depthwise3x3_int8.launches = launches
        bms, by = _dw_bound(cfg)
        return dict(kernel="depthwise3x3_int8", **cfg, misaligned=misaligned,
                    ok=ok, max_abs_err=err, ms=None, plain_ms=None,
                    library_ms=None, bound_ms=bms, bound_by=by)
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
                bound_ms=bms, bound_by=by, share_of_bound=bms / ms)


# extra depthwise cases the path does not give: ragged C, odd H/W at s1
# and s2, float outputs, leaky_relu, no bias, a misaligned x
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
    # odd sizes at stride 2: MobileNet v1 at 200 px reaches 25 x 25 at a
    # stride-2 depthwise conv; 7 x 9 odd in both, with a ragged C
    (dict(N=32, H=25, W=25, C=256, stride=2, activation="relu6", bias=True,
          out="int8"), False),
    (dict(N=8, H=7, W=9, C=40, stride=2, activation="relu", bias=True,
          out="int8"), False),
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
            f"({r['bound_by']}, {100 * r['share_of_bound']:.1f}% of it) "
            f"lib=none cudnn-bf16-grouped-conv={cud}")
    for name in per_model:
        rows = [r for r in results if r["calls"][name]]

        def total(key, rows=rows, name=name):
            return sum(r[key] * r["calls"][name] for r in rows)

        log(f"[kernel] depthwise3x3_int8 per {name} forward: "
            f"{sum(r['calls'][name] for r in rows)} calls, ms={total('ms'):.4f} "
            f"bound={total('bound_ms'):.4f} "
            f"({100 * total('bound_ms') / total('ms'):.1f}% of it) "
            f"plain={total('plain_ms'):.3f}")
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


# -------------------------------------------------------------- bottleneck

# cases the path does not give: no bias, float32 and bf16 outputs, H that
# is not a multiple of the band's rows in each of the kernel's two
# configurations (30: bands of 8, 8, 8, 6; 29: 6, 6, 6, 6, 5; 15: 8, 7), and
# a C that is not a multiple of 128 with one block an SM (9 x 60)
BN_EXTRA = [
    dict(N=32, H=28, W=28, C=512, P=128, bias=False, out="int8"),
    dict(N=32, H=14, W=14, C=1024, P=256, bias=True, out="float32"),
    dict(N=32, H=56, W=56, C=256, P=64, bias=True, out="bfloat16"),
    dict(N=16, H=30, W=30, C=256, P=64, bias=True, out="int8"),
    dict(N=8, H=29, W=29, C=512, P=128, bias=True, out="int8"),
    dict(N=8, H=15, W=13, C=1024, P=256, bias=True, out="int8"),
    dict(N=4, H=9, W=60, C=192, P=64, bias=True, out="int8"),
]
_OUT_BYTES = {"int8": 1, "float32": 4, "bfloat16": 2}
# blocks narrower than the kernel's multiples of 64 channels, which the
# wrapper widens with zero channels (C 32 / P 8: Faster R-CNN's first stage
# at base_width 8; C 96 / P 40: neither a multiple of 64)
BN_NARROW = [
    dict(N=2, H=56, W=56, C=32, P=8, bias=True, out="int8"),
    dict(N=2, H=28, W=28, C=96, P=40, bias=False, out="float32"),
]


def _bn_bound(cfg):
    n, h, w, c, p = (cfg[k] for k in ("N", "H", "W", "C", "P"))
    nbytes = (n * h * w * c * (1 + _OUT_BYTES[cfg["out"]]) + 2 * c * p
              + 9 * p * p + 4 * (2 * p + c) * (2 if cfg["bias"] else 1))
    ops = 2 * n * h * w * (2 * c * p + 9 * p * p)
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_INT8_OPS * 1e3
    return (t_o, "operations") if t_o >= t_b else (t_b, "bytes")


def check_bottleneck(cfg, gen):
    """bottleneck_int8 against its plain version and against the unfused
    chain of the port's kernels (matmul_int8 -> conv3x3_int8 ->
    matmul_int8) on random int8 data, the JAX package's test's ranges: int8
    outputs equal, float outputs within rtol 1e-6.  Times from CUDA-graph
    replay with x rotated through >= 100 MB of copies."""
    from anakin_tpu_torch.kernels import (bottleneck_int8, bottleneck_int8_plain,
                                          conv3x3_int8, matmul_int8)
    from anakin_tpu_torch.kernels.matmul_int8 import prepare_b

    n, h, w, c, p = (cfg[k] for k in ("N", "H", "W", "C", "P"))

    def ints(lim, *shape):
        return torch.randint(-lim, lim, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def unif(k):
        return torch.rand(k, generator=gen, device="cuda") * 2e-4 + 1e-4

    def normal(k):
        return (torch.randn(k, generator=gen, device="cuda") * 0.1
                if cfg["bias"] else None)

    x = ints(80, n, h, w, c)
    wa, wb, wc = ints(60, c, p), ints(20, 3, 3, p, p), ints(60, p, c)
    wsa, wsb, wsc = unif(p), unif(p), unif(c)
    ba, bb, bc = normal(p), normal(p), normal(c)
    kw = dict(in_scale=2e-2, a_scale=1.5e-2, b_scale=1.2e-2, res_scale=2e-2)
    if cfg["out"] == "int8":
        kw["out_scale"] = 2.5e-2
    else:
        kw["out_dtype"] = getattr(torch, cfg["out"])
    weights = (wa, wsa, wb, wsb, wc, wsc, ba, bb, bc)
    pa, pb, pc = (prepare_b(t) for t in (wa, wb, wc))  # as a Net holds them
    prepared = (pa, wsa, pb, wsb, pc, wsc, ba, bb, bc)

    def chain(x_):
        rows = x_.reshape(-1, c)
        a = matmul_int8(rows, pa, wsa, ba, in_scale=kw["in_scale"],
                        activation="relu", out_scale=kw["a_scale"])
        b = conv3x3_int8(a.reshape(n, h, w, p), pb, wsb, bb,
                         in_scale=kw["a_scale"], activation="relu",
                         out_scale=kw["b_scale"])
        return matmul_int8(b.reshape(-1, p), pc, wsc, bc, rows,
                           in_scale=kw["b_scale"], activation="relu",
                           out_scale=kw.get("out_scale"),
                           out_dtype=kw.get("out_dtype", torch.float32),
                           residual_scale=kw["res_scale"]).reshape(n, h, w, c)

    wrappers = (bottleneck_int8, matmul_int8, conv3x3_int8)
    launches = [f.launches for f in wrappers]
    got = bottleneck_int8(x, *prepared, **kw)
    got_raw = bottleneck_int8(x, *weights, **kw)  # prepared for this call
    want = bottleneck_int8_plain(x, *weights, **kw)
    unfused = chain(x)
    torch.cuda.synchronize()
    chain_equal = torch.equal(got, unfused) and torch.equal(got, got_raw)
    if got.dtype == torch.int8:
        err = float((got.int() - want.int()).abs().max())
        ok = err == 0
    else:
        d = (got.float() - want.float()).abs()
        err = float(d.max())
        ok = bool((d <= 1e-6 * want.float().abs()).all())
    n_copies = max(2, -(-100 * 2 ** 20 // x.numel()))
    copies = [(x.clone(),) for _ in range(n_copies)]
    iters = n_copies * -(-20 // n_copies)
    ms = graph_ms(rotating(lambda x_: bottleneck_int8(x_, *prepared, **kw),
                           copies), iters=iters)
    unfused_ms = graph_ms(rotating(chain, copies), iters=iters)
    plain_ms = graph_ms(rotating(lambda x_: bottleneck_int8_plain(
        x_, *weights, **kw), copies[:2]), iters=2)
    for f, v in zip(wrappers, launches):
        f.launches = v
    bms, by = _bn_bound(cfg)
    return dict(kernel="bottleneck_int8", **cfg, ok=ok and chain_equal,
                max_abs_err=err, unfused_chain_equal=chain_equal, ms=ms,
                plain_ms=plain_ms, unfused_chain_ms=unfused_ms,
                library_ms=None, bound_ms=bms, bound_by=by,
                share_of_bound=bms / ms)


def check_narrow_bottleneck(cfg, gen):
    """A block narrower than the kernel's multiples of 64 channels (the
    wrapper pads it with zero channels and slices the output) on prepared
    and on raw weights, against its plain version: bit-equal, untimed; one
    launch a call."""
    from anakin_tpu_torch.kernels import bottleneck_int8, bottleneck_int8_plain
    from anakin_tpu_torch.kernels.matmul_int8 import prepare_b

    n, h, w, c, p = (cfg[k] for k in ("N", "H", "W", "C", "P"))

    def ints(lim, *shape):
        return torch.randint(-lim, lim, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    x = ints(80, n, h, w, c)
    wa, wb, wc = ints(60, c, p), ints(20, 3, 3, p, p), ints(60, p, c)
    scales = [torch.rand(k, generator=gen, device="cuda") * 2e-4 + 1e-4
              for k in (p, p, c)]
    biases = [torch.randn(k, generator=gen, device="cuda") * 0.1
              if cfg["bias"] else None for k in (p, p, c)]
    kw = dict(in_scale=2e-2, a_scale=1.5e-2, b_scale=1.2e-2, res_scale=2e-2)
    if cfg["out"] == "int8":
        kw["out_scale"] = 2.5e-2
    else:
        kw["out_dtype"] = getattr(torch, cfg["out"])
    raw = (wa, scales[0], wb, scales[1], wc, scales[2], *biases)
    prepared = (prepare_b(wa), scales[0], prepare_b(wb), scales[1],
                prepare_b(wc), scales[2], *biases)
    launches = bottleneck_int8.launches
    got = bottleneck_int8(x, *prepared, **kw)
    got_raw = bottleneck_int8(x, *raw, **kw)
    want = bottleneck_int8_plain(x, *raw, **kw)
    torch.cuda.synchronize()
    n_launches = bottleneck_int8.launches - launches
    bottleneck_int8.launches = launches
    equal = torch.equal(got, want) and torch.equal(got_raw, want)
    err = float((got.float() - want.float()).abs().max())
    return dict(kernel="bottleneck_int8", **cfg, ok=equal and n_launches == 2,
                max_abs_err=err, launches=n_launches)


def bottleneck_phase(report, card, resnet):
    """Phase 14: the 12 identity blocks of phase 2's ResNet-50 b128 net
    through bottleneck_int8, then the kernel against its plain version."""
    from anakin_tpu_torch.kernels.bottleneck_int8 import identity_block
    from anakin_tpu_torch.kernels.matmul_int8 import prepare_b
    from anakin_tpu_torch.models import identity_bottlenecks
    from anakin_tpu_torch.runtime.net import build_forward

    net, g, x = resnet
    blocks = identity_bottlenecks(g)
    widths = [g.params[a.inputs[1]].shape[3] for a, _, _ in blocks]
    if widths != [64] * 2 + [128] * 3 + [256] * 5 + [512] * 2:
        raise AssertionError(f"identity blocks of widths {widths}")
    edges = [e for a, _, c in blocks for e in (a.inputs[0], c.outputs[0])]
    fwd, _ = build_forward(g, "bf16", tap_edges=edges)
    with torch.inference_mode():
        taps = fwd(net.params, {"input": x})
        reset_counts()
        prepared_before = prepare_b.calls
        ys = [identity_block(b, net.params, taps[b[0].inputs[0]],
                             prepared=net.prepared)
              for b in blocks]
        torch.cuda.synchronize()
    counts = read_counts()
    n_prepared = prepare_b.calls - prepared_before
    log(f"[bottleneck] launches over the {len(blocks)} identity blocks: "
        f"{counts}; weights prepared {n_prepared}")
    if counts != dict(no_launches(), bottleneck_int8=len(blocks)) or n_prepared:
        raise AssertionError(f"expected {len(blocks)} bottleneck_int8 launches "
                             f"and no weight prepared, got {counts}, "
                             f"{n_prepared} prepared")
    calls, worst = {}, 0.0
    for (a, _, c), y in zip(blocks, ys):
        want = taps[c.outputs[0]]
        if y.dtype != want.dtype or y.shape != want.shape:
            raise AssertionError(f"{c.name}: {y.dtype} {tuple(y.shape)} against "
                                 f"{want.dtype} {tuple(want.shape)}")
        if y.dtype == torch.int8:
            if not torch.equal(y, want):
                raise AssertionError(f"{c.name}: int8 block output differs "
                                     f"from the net's")
        else:
            d = (y.float() - want.float()).abs()
            worst = max(worst, float(d.max()))
            if not bool((d <= 1e-6 * want.float().abs()).all()):
                raise AssertionError(f"{c.name}: float block output differs "
                                     f"by {float(d.max())}")
        n_, h, w, cc = y.shape
        cfg = dict(N=n_, H=h, W=w, C=cc, P=g.params[a.inputs[1]].shape[3],
                   bias=bool(a.attr("has_bias")),
                   out="int8" if y.dtype == torch.int8
                   else str(y.dtype).split(".")[-1])
        key = tuple(sorted(cfg.items()))
        calls[key] = calls.get(key, 0) + 1
    log(f"[bottleneck] all {len(blocks)} blocks equal the net's block outputs "
        f"(int8 bit for bit; float max abs diff {worst:g})")
    report["bottleneck"] = dict(blocks=len(blocks), launches=counts,
                                weights_prepared=n_prepared,
                                float_max_abs_diff=worst)
    del taps, ys

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    results = []
    for cfg, n_calls in [(dict(k), v) for k, v in calls.items()] + [
            (e, 0) for e in BN_EXTRA]:
        r = check_bottleneck(cfg, gen)
        r["calls_per_run"] = n_calls
        results.append(r)
        log(f"[kernel] bottleneck_int8 {r['N']}x{r['H']}x{r['W']}x{r['C']} "
            f"P{r['P']} bias={int(r['bias'])} out={r['out']} x{n_calls} "
            f"err={r['max_abs_err']:g} chain-equal={r['unfused_chain_equal']} "
            f"ms={r['ms']:.4f} unfused-chain={r['unfused_chain_ms']:.4f} "
            f"plain={r['plain_ms']:.3f} bound={r['bound_ms']:.4f} "
            f"({r['bound_by']}, {100 * r['share_of_bound']:.1f}% of it) "
            f"lib=none")
    narrow = []
    for cfg in BN_NARROW:
        r = check_narrow_bottleneck(cfg, gen)
        narrow.append(r)
        log(f"[kernel] bottleneck_int8 narrow {r['N']}x{r['H']}x{r['W']}x"
            f"{r['C']} P{r['P']} bias={int(r['bias'])} out={r['out']} "
            f"(padded to multiples of 64 by the wrapper): err="
            f"{r['max_abs_err']:g}, {r['launches']} launches for 2 calls, "
            f"untimed")
    report["bottleneck_narrow"] = narrow
    if not all(r["ok"] for r in narrow):
        raise AssertionError(f"a narrow block differs from its plain version: "
                             f"{narrow}")
    path = [r for r in results if r["calls_per_run"]]

    def total(key):
        return sum(r[key] * r["calls_per_run"] for r in path)

    log(f"[kernel] bottleneck_int8 over the 12 blocks: ms={total('ms'):.4f} "
        f"unfused-chain={total('unfused_chain_ms'):.4f} "
        f"bound={total('bound_ms'):.4f} "
        f"({100 * total('bound_ms') / total('ms'):.1f}% of it) "
        f"plain={total('plain_ms'):.3f}")
    report["bottleneck"].update(ms=total("ms"), bound_ms=total("bound_ms"),
                                unfused_chain_ms=total("unfused_chain_ms"),
                                plain_ms=total("plain_ms"))
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel differs from its plain version or the "
                             f"unfused chain: {bad}")
    report["bottleneck_kernel_configs"] = results
    log("[kernel] bottleneck_int8 has no library_ms: PyTorch has no int8 "
        "convolution on CUDA")
    return results, counts["bottleneck_int8"]


# ------------------------------------------------------------- scheduler

# prompt lengths cycle through buckets 64, 256, 512, 768, 1024 and 1536, so
# the bucket admissions from 512 on take the flash kernel
SCHED_LENGTHS = (40, 200, 512, 700, 1000, 1500)
SCHED_REQUESTS, SCHED_NEW, SCHED_WINDOW = 12, 64, 16
SCHED_STOPPED = 3  # requests given a stop token their output reaches
SCHED_SMALL_LAYERS = 2  # depth of the chunked, sampled check


def _serve(sched, prompts, stops):
    """Submit every request at once; (results, wall seconds)."""
    t0 = time.perf_counter()
    futs = [sched.submit(p, max_new_tokens=SCHED_NEW,
                         stop_tokens=stops.get(i, ()))
            for i, p in enumerate(prompts)]
    out = [f.result(timeout=900) for f in futs]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _window_feed(cfg, K):
    """A greedy window's inputs: every slot decodes K steps from its own
    position (up to max_seq - K - 1)."""
    B = LLM_BATCH
    pos = np.minimum(np.arange(B) * 287 + 40, cfg.max_seq - K - 1)
    return dict(tok=np.arange(1, B + 1, dtype=np.int32)[:, None],
                pos=pos.astype(np.int32), rem=np.full((B,), K, np.int32),
                rid=np.arange(B, dtype=np.int32), gen0=np.zeros((B,), np.int32),
                temp=np.zeros((B,), np.float32), topk=np.zeros((B,), np.int32),
                topp=np.zeros((B,), np.float32),
                stop_ids=np.full((B, 8), -1, np.int32))


def _replay_equals_eager(sched, cfg):
    """One captured decode step (`Net.compile`, the caches bound as static
    inputs) against the eager step (`Net.prediction`) on the same inputs,
    each on its own copy of random int8 caches: logits and every cache
    equal, bit for bit."""
    B = LLM_BATCH
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    shape = (B, cfg.kv_heads, cfg.max_seq, cfg.head_dim)
    base = {k: torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8) for k in sched._caches}
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos = torch.tensor(np.minimum(np.arange(B) * 287 + 3, cfg.max_seq - 1),
                       dtype=torch.int32, device="cuda")
    eager_c = {k: v.clone() for k, v in base.items()}
    graph_c = {k: v.clone() for k, v in base.items()}
    net, logits_e = sched.net, sched._logits_edge
    want = net.prediction(dict(eager_c, input=tok, pos=pos))
    step = net.compile(dict(graph_c, input=tok, pos=pos), static=graph_c)
    got = step({"input": tok, "pos": pos})
    torch.cuda.synchronize()
    same_logits = torch.equal(got[logits_e], want[logits_e])
    same_caches = all(torch.equal(graph_c[k], eager_c[k]) for k in base)
    log(f"[sched] one captured decode step replayed vs the eager step: "
        f"logits equal {same_logits}, {len(base)} caches equal {same_caches}")
    if not (same_logits and same_caches):
        raise AssertionError("the replayed decode step differs from the eager "
                             "step")
    return dict(logits_equal=same_logits, caches_equal=same_caches)


def _chunked_sampled(params, card):
    """Chunked admission (the chunk step a captured graph), cache views on
    and device sampling in the windows, at full width and 2 of the 16
    layers: a greedy request, the same request at temperature 0.9 with
    top_k 1 (which must give the greedy tokens) and a nucleus-sampled one;
    every token in range."""
    from anakin_tpu_torch.models import TransformerConfig
    from anakin_tpu_torch.runtime import DecodeScheduler
    from anakin_tpu_torch.runtime.graphs import CapturedStep

    cfg = TransformerConfig(**dict(LLM_CFG, layers=SCHED_SMALL_LAYERS))
    small = {k: v for k, v in params.items()
             if not re.match(r"l(\d+)\.", k)
             or int(k[1:].split(".")[0]) < SCHED_SMALL_LAYERS}
    rng = np.random.default_rng(6)
    p40, p200 = (rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
                 for n in (40, 200))
    t0 = time.perf_counter()
    sched = DecodeScheduler(cfg, batch=LLM_BATCH, params=small,
                            precision="bf16", kv_cache_dtype="int8",
                            weight_only="w4", fuse_window=SCHED_WINDOW,
                            prefill_mode="chunked", device="cuda")
    try:
        futs = [sched.submit(p40, max_new_tokens=16),
                sched.submit(p40, max_new_tokens=16, temperature=0.9, top_k=1),
                sched.submit(p200, max_new_tokens=16, temperature=1.0,
                             top_k=40, top_p=0.9)]
        greedy, top1, sampled = (f.result(timeout=600) for f in futs)
        wall_s = time.perf_counter() - t0
        runs = [sched._vrun, *sched._fused_runs.values()]
        keys = sorted(sched._fused_runs)
    finally:
        sched.close()
    new = np.concatenate([t[-16:] for t in (greedy, top1, sampled)])
    log(f"[sched] chunked admission, views on, device sampling, "
        f"{SCHED_SMALL_LAYERS} layers: 3 requests in {wall_s:.2f} s with the "
        f"scheduler's build, windows {keys} (sampling, view), top_k 1 equals "
        f"greedy: {np.array_equal(greedy, top1)} | {card}")
    if not all(isinstance(r, CapturedStep) for r in runs) or not keys:
        raise AssertionError("the chunk step and the windows were not "
                             "captured graphs")
    if not np.array_equal(greedy, top1):
        raise AssertionError("top_k 1 sampling differs from greedy")
    if new.min() < 0 or new.max() >= cfg.vocab:
        raise AssertionError("sampled token out of range")
    return dict(wall_s=wall_s, layers=SCHED_SMALL_LAYERS,
                windows=[list(k) for k in keys], top_k1_equals_greedy=True)


ADMISSION_WINDOWS = 5  # the small buckets are the host's and spread widely


def admission_ms(sched, card):
    """ms of one admission of each bucket the scheduler has made (one
    dispatch at b8, every slot real), from CUDA events: {bucket: (median,
    min, max)} over ADMISSION_WINDOWS admissions after one warm-up."""
    admission = {}
    with torch.inference_mode():
        for L, run in sorted(sched._prefill_runs.items()):
            ids = np.zeros((LLM_BATCH, L), np.int32)
            nreal = np.full((LLM_BATCH,), L, np.int32)
            times = [cuda_ms(lambda: run(ids, nreal, []), iters=1,
                             warmup=int(i == 0), windows=1)
                     for i in range(ADMISSION_WINDOWS)]
            admission[L] = (statistics.median(times), min(times), max(times))
    log(f"[sched] admission ms per bucket (one dispatch, b{LLM_BATCH}, "
        f"flash from 512; median of {ADMISSION_WINDOWS} (min-max)): "
        + ", ".join(f"{L}: {m:.1f} ({lo:.1f}-{hi:.1f})"
                    for L, (m, lo, hi) in admission.items())
        + f" | {card}")
    return admission


def w4_admission_only(report, card):
    """`--w4-only`: phase 7's timed matmul_w4 rows at phase 15's bucket
    admissions, then phase 15's admission ms per bucket on a scheduler
    built as phase 15 builds it, each bucket's admission made directly (no
    requests served).  It uses only what the port had before the wgmma
    route, so the same script times a checkout of an earlier tree (copy it
    there and run it from that directory): parent and change on one card."""
    from anakin_tpu_torch.models import TransformerConfig, make_transformer_params
    from anakin_tpu_torch.runtime import DecodeScheduler

    cfg = TransformerConfig(**LLM_CFG)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rows = []
    for m, k, n, grp, dt, bs, calls in admission_w4_cases(cfg):
        rows.append(check_w4(m, k, n, grp, dt, gen, calls, bf16_scales=bs))
        log_w4_row(rows[-1], calls)
    if not all(r["ok"] for r in rows):
        raise AssertionError(f"kernel differs from its plain version: "
                             f"{[r for r in rows if not r['ok']]}")
    report["w4_admission_rows"] = rows
    t0 = time.perf_counter()
    params = make_transformer_params(cfg, 0)
    sched = DecodeScheduler(cfg, batch=LLM_BATCH, params=params,
                            precision="bf16", kv_cache_dtype="int8",
                            weight_only="w4", cache_view="off",
                            fuse_window=0, device="cuda")
    try:
        for L in admission_buckets(cfg):
            sched._prefill_runs[L] = sched._make_prefill_run(L)
        log(f"[sched] weights, scheduler and {len(sched._prefill_runs)} "
            f"admissions built in {time.perf_counter() - t0:.1f} s")
        report["admission_ms"] = admission_ms(sched, card)
    finally:
        sched.close()


def scheduler_phase(report, cfg, params, card):
    """Phase 15: the port's DecodeScheduler at full width (b8, bf16, int8
    KV cache, w4, bucket admission, cache views off), one scheduler: 12
    greedy requests of 64 new tokens through the per-step path
    (`fuse_window` 0: one captured step replayed a token), then, with
    `fuse_window` 16 (read at every step) and the counts set to 0 just
    before and read just after, one request that captures the window graph
    and the 12 requests again through fused windows (CUDA graphs), against
    the per-step path's tokens; then one captured step against the eager
    step, the admission time of each bucket, one window replayed, profiled
    and timed beside the same window run eagerly, and the chunked, sampled
    check."""
    import anakin_tpu_torch.runtime.decode_scheduler as ds
    from anakin_tpu_torch.runtime import DecodeScheduler
    from anakin_tpu_torch.runtime.graphs import CapturedStep

    # the host seconds of each graph's weight-only rewrite: the first
    # quantizes the weights, the later ones take its arrays (`packed`)
    quantize, rewrite_s = ds.weight_only_quantize, []

    def timed_quantize(*a, **kw):
        t = time.perf_counter()
        g = quantize(*a, **kw)
        rewrite_s.append(time.perf_counter() - t)
        return g

    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, (SCHED_LENGTHS[i % 6],)).astype(
        np.int32) for i in range(SCHED_REQUESTS)]
    # views off: a view changes the attention's reduction length, and so
    # the order of its float sums, with the batch's positions; the two runs
    # below batch their requests differently
    t0 = time.perf_counter()
    ds.weight_only_quantize = timed_quantize
    try:
        sched = DecodeScheduler(cfg, batch=LLM_BATCH, params=params,
                                precision="bf16", kv_cache_dtype="int8",
                                weight_only="w4", cache_view="off",
                                fuse_window=0, device="cuda")
        build_s = time.perf_counter() - t0
        ref, ref_s = _serve(sched, prompts, {})
    finally:
        ds.weight_only_quantize = quantize
    try:
        ref_steps = sched.steps_run
        ref_tok = sum(len(r) - len(p) for r, p in zip(ref, prompts))
        log(f"[sched] per-step path: {SCHED_REQUESTS} requests x {SCHED_NEW} "
            f"tokens in {ref_s:.2f} s, {ref_tok / ref_s:.1f} tokens/s "
            f"({ref_steps} steps; scheduler built in {build_s:.1f} s); "
            f"weight-only rewrite of each graph: "
            + ", ".join(f"{t:.3f}" for t in rewrite_s) + " s (the first "
            f"quantizes, the later ones reuse its arrays)")
        # stop tokens for three requests: a token their greedy output
        # reaches first at index 8 or later
        stops = {}
        for i, (r, p) in enumerate(zip(ref, prompts)):
            gen_i = [int(t) for t in r[len(p):]]
            j = next((j for j in range(8, SCHED_NEW)
                      if gen_i[j] not in gen_i[:j]), None)
            if j is not None and len(stops) < SCHED_STOPPED:
                stops[i] = (gen_i[j],)
        if len(stops) < SCHED_STOPPED:
            raise AssertionError("fewer than three requests reach a new token "
                                 "after their eighth")

        sched.fuse_window = SCHED_WINDOW
        tap = launched_llm_shapes()
        reset_counts()
        wgmma0 = wgmma_flash_launches()
        # one request of a window's tokens: its first window captures the
        # graph that every later window replays
        t0 = time.perf_counter()
        with tap:
            warm = sched.submit(prompts[0], max_new_tokens=SCHED_WINDOW + 1
                                ).result(timeout=900)
        capture_s = time.perf_counter() - t0
        if not np.array_equal(warm, ref[0][:len(warm)]):
            raise AssertionError("the capturing request's tokens differ from "
                                 "the per-step path's")
        ph0, steps0 = dict(sched.phase_seconds), sched.steps_run
        windows0, buckets0 = sched.fused_windows_run, sched.bucket_prefills_run
        with tap:
            got, wall_s = _serve(sched, prompts, stops)
        counts = read_counts()
        # the launches of the wgmma route (bf16 x, M > 16, G % 32 == 0: the
        # bucket admissions' projections), by shape
        wgmma_calls = {k: n for k, n in tap.w4_calls.items()
                       if k[0] > 16 and k[4] == str(torch.bfloat16)
                       and k[3] % 32 == 0}
        log(f"[sched] launches while serving (warm-up and capture of the "
            f"window graph, the eager bucket prefills; a replay counts "
            f"nothing): {counts}; matmul_w4 at M > 16: "
            + ", ".join(f"{k[0]}x{k[1]}->{k[2]} x{n}"
                        for k, n in sorted(wgmma_calls.items())))
        if counts != dict(no_launches(), flash_attention=counts[
                "flash_attention"], matmul_w4=counts["matmul_w4"],
                matmul_w4_wgmma=counts["matmul_w4_wgmma"]) \
                or not counts["flash_attention"] or not counts["matmul_w4"] \
                or counts["matmul_w4_wgmma"] != sum(wgmma_calls.values()) \
                or not counts["matmul_w4_wgmma"]:
            raise AssertionError(f"expected flash_attention and matmul_w4 "
                                 f"launches only, the M > 16 ones on the "
                                 f"wgmma route, got {counts}")
        require_wgmma_flash("the admissions", counts,
                            wgmma_flash_launches() - wgmma0)
        for i, (g, r) in enumerate(zip(got, ref)):
            want = r
            if i in stops:
                n = len(prompts[i]) + [int(t) for t in r[len(prompts[i]):]
                                       ].index(stops[i][0]) + 1
                want = r[:n]
                if int(g[-1]) != stops[i][0]:
                    raise AssertionError(f"request {i} did not end on its "
                                         f"stop token")
            if not np.array_equal(g, want):
                raise AssertionError(f"request {i}: fused-window tokens differ "
                                     f"from the per-step path's")
        win_runs = list(sched._fused_runs.values())
        if not all(isinstance(r, CapturedStep) for r in win_runs) or \
                not isinstance(sched._step_run, CapturedStep):
            raise AssertionError("the windows and the per-step decode were "
                                 "not captured graphs")
        windows = sched.fused_windows_run - windows0
        buckets = sched.bucket_prefills_run - buckets0
        k_steps = sched.steps_run - steps0 - buckets
        ph = {k: v - ph0[k] for k, v in sched.phase_seconds.items()}
        n_tok = sum(len(g) - len(p) for g, p in zip(got, prompts))
        res = dict(requests=SCHED_REQUESTS, new_tokens=SCHED_NEW,
                   window=SCHED_WINDOW, batch=LLM_BATCH, launches=counts,
                   wgmma_calls=[[list(k), n] for k, n in
                                sorted(wgmma_calls.items())],
                   scheduler_build_s=build_s, rewrite_s=rewrite_s,
                   capture_request_s=capture_s, tokens=n_tok, wall_s=wall_s,
                   tokens_per_s=n_tok / wall_s, per_step_wall_s=ref_s,
                   per_step_tokens_per_s=ref_tok / ref_s, windows=windows,
                   window_steps_with_work=k_steps, bucket_prefills=buckets,
                   phase_seconds=ph, captured_windows=len(win_runs),
                   window_ms_per_step_with_work=ph["window"] / k_steps * 1e3,
                   window_ms_per_step_run=ph["window"] / (
                       windows * SCHED_WINDOW) * 1e3,
                   stopped={i: int(s[0]) for i, s in stops.items()})
        log(f"[sched] fused windows (the graph captured by one request in "
            f"{capture_s:.2f} s): {n_tok} tokens in {wall_s:.2f} s, "
            f"{n_tok / wall_s:.1f} tokens/s ({ref_tok / ref_s:.1f} on the "
            f"per-step path); {windows} windows, {k_steps} steps with work, "
            f"{res['window_ms_per_step_with_work']:.3f} ms a step with work, "
            f"{res['window_ms_per_step_run']:.3f} ms a step run; {buckets} "
            f"bucket prefills; phase seconds {ph}; tokens equal to the "
            f"per-step path's, {len(stops)} requests ended on their stop "
            f"tokens | {card}")

        res["replay_vs_eager_step"] = _replay_equals_eager(sched, cfg)

        res["admission_ms"] = admission_ms(sched, card)
        with torch.inference_mode():
            K = SCHED_WINDOW
            run = sched._fused_runs[(False, 0)]
            feed = _window_feed(cfg, K)
            fn = sched._window_fn(K, False, 0)
            x = dict(sched._caches, **{k: torch.as_tensor(v).cuda()
                                       for k, v in feed.items()})
            # the same window from the same caches (each step writes its
            # row before it reads it): the same tokens and k_done
            eager_packed = fn(x)["packed"]
            same = torch.equal(run(feed)["packed"], eager_packed)
            log(f"[sched] the window replayed and run eagerly on the same "
                f"inputs: packed tokens equal {same}")
            if not same:
                raise AssertionError("the replayed window's tokens differ "
                                     "from the eager window's")
            replay_ms = cuda_ms(lambda: run(feed), iters=1, warmup=0, windows=3)
            eager_ms = cuda_ms(lambda: fn(x), iters=1, warmup=0, windows=2)
            # a window runs its K steps even after every slot froze: the
            # steps without work in the counted round, at the replay's rate
            tail = windows * K - k_steps
            log(f"[sched] one window of {K} steps: replayed {replay_ms:.3f} ms "
                f"({replay_ms / K:.3f} a step), eager {eager_ms:.3f} ms "
                f"({eager_ms / K:.3f} a step); the counted round ran {tail} "
                f"steps without work, {tail * replay_ms / K:.1f} ms of device "
                f"time | {card}")
            res.update(window_replay_ms=replay_ms, window_eager_ms=eager_ms,
                       tail_steps=tail, tail_ms=tail * replay_ms / K)
            res["profile_window"] = profile_step(lambda: run(feed), replay_ms,
                                                 "sched window")
    finally:
        sched.close()
    del sched
    res["chunked_sampled"] = _chunked_sampled(params, card)
    report["scheduler"] = res
    return counts, wgmma_calls


# ------------------------------------------------------------ speculative

# the draft of the speculative phase: the 1B-class target's vocabulary and
# context, E 256, 4 heads, 2 layers (the JAX suite's draft shape,
# `tools/bench_suite.py:330`)
SPEC_DRAFT = dict(vocab=32000, embed=256, heads=4, kv_heads=4, layers=2,
                  max_seq=2048)
SPEC_K, SPEC_NEW, SPEC_PROFILE_NEW = 4, 64, 16
SPEC_SMALL_LAYERS = 2  # depth of the exactness check (draft = target)
SPEC_PATHS = ("generate", "generate_round_fused", "generate_fused")


def _first_layers(params, n):
    """The params of a transformer's first n layers (and the rest of it)."""
    return {k: v for k, v in params.items()
            if not re.match(r"l(\d+)\.", k)
            or int(re.match(r"l(\d+)\.", k).group(1)) < n}


def speculative_phase(report, cfg, params, card):
    """Phase 16: `SpeculativeSession` at the 1B-class target (bf16, int8 KV
    cache, k 4, batch 1, a 512-token prompt, 64 new tokens) with a random
    E-256 draft: each of the three loops once to warm up (captures), then
    timed with the counts set to 0 just before and read just after (flash
    in each prefill, nothing else: the rounds run no kernel wrapper and a
    replay counts nothing); tokens equal across the loops; beside
    `GenerationSession`'s b1 greedy; the host's graph launches a round;
    then draft = target at 2 of the 16 layers in float32: one round
    accepts every draft on each loop, and over 64 tokens each loop's tokens
    equal greedy's (acceptance at least 0.5, the JAX test's bound)."""
    from anakin_tpu_torch.models import TransformerConfig
    from anakin_tpu_torch.runtime import GenerationSession, SpeculativeSession

    t0 = time.perf_counter()
    dcfg = TransformerConfig(**SPEC_DRAFT)
    spec = SpeculativeSession(cfg, dcfg, params=params, k=SPEC_K,
                              precision="bf16", kv_cache_dtype="int8")
    greedy = GenerationSession(cfg, batch=1, params=params, precision="bf16",
                               kv_cache_dtype="int8",
                               device=spec.device, prefill_buckets=False)
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab, (1, PROMPT)).astype(np.int32)
    for path in SPEC_PATHS:                        # warm-up and capture
        getattr(spec, path)(prompt, SPEC_NEW)
    greedy.generate(prompt, SPEC_NEW)
    torch.cuda.synchronize()
    log(f"[spec] sessions, weights, warm-up and capture of the loops: "
        f"{time.perf_counter() - t0:.1f} s")

    res, outs = {}, {}
    flash_per_prefill = cfg.layers + dcfg.layers
    for path in SPEC_PATHS + ("greedy",):
        before = {c: getattr(spec, c) for c in (
            "rounds", "drafts_accepted", "drafts_proposed", "tokens_committed")}
        reset_counts()
        wgmma0 = wgmma_flash_launches()
        t0 = time.perf_counter()
        out = (greedy.generate(prompt, SPEC_NEW) if path == "greedy"
               else getattr(spec, path)(prompt, SPEC_NEW))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        want = cfg.layers if path == "greedy" else flash_per_prefill
        if counts != dict(no_launches(), flash_attention=want):
            raise AssertionError(f"{path}: expected {want} flash_attention "
                                 f"launches (the prefills), got {counts}")
        require_wgmma_flash(f"{path}'s prefills", counts,
                            wgmma_flash_launches() - wgmma0)
        outs[path] = out
        delta = {c: getattr(spec, c) - v for c, v in before.items()}
        rate = (delta["drafts_accepted"] / delta["drafts_proposed"]
                if delta["drafts_proposed"] else 0.0)
        res[path] = dict(wall_s=wall, ms_per_token=wall / SPEC_NEW * 1e3,
                         launches=counts, **delta, acceptance_rate=rate)
        log(f"[spec] {path}: {wall * 1e3:.1f} ms for {SPEC_NEW} tokens, "
            f"{wall / SPEC_NEW * 1e3:.3f} ms/token (prefill included); "
            f"rounds {delta['rounds']}, acceptance {rate:.3f}; launches "
            f"{counts} | {card}")
    new = outs["generate"][:, PROMPT:]
    if outs["generate"].shape != (1, PROMPT + SPEC_NEW) or new.min() < 0 \
            or new.max() >= cfg.vocab:
        raise AssertionError(f"bad tokens {outs['generate'].shape}")
    for path in SPEC_PATHS[1:]:
        if not np.array_equal(outs[path], outs["generate"]):
            raise AssertionError(f"{path} gives other tokens than generate")
    # against greedy: the common prefix, and the target's top-2 gap where
    # the two part (an exact-length prefill of the greedy tokens)
    g_new = outs["greedy"][0, PROMPT:]
    diff = np.nonzero(g_new != new[0])[0]
    common = int(diff[0]) if len(diff) else SPEC_NEW
    gap = None
    if len(diff):
        lg, _ = greedy._prefill(torch.from_numpy(
            outs["greedy"][:, :PROMPT + common]).cuda())
        top2 = torch.topk(lg[0, 0].float(), 2).values
        gap = float(top2[0] - top2[1])
    res["common_prefix_with_greedy"] = common
    res["top2_gap_at_first_difference"] = gap
    log(f"[spec] the three loops give equal tokens; against greedy: common "
        f"prefix {common} of {SPEC_NEW} tokens"
        + ("" if gap is None else f", the target's top-2 logit gap where they "
           f"part {gap:.4g}"))
    # a profiled generation of each captured loop, SPEC_PROFILE_NEW tokens
    # (a trace of the 64 holds 220,000 kernels): the device's busy share and
    # kernels, the host's launch calls (one graph launch a round / a window;
    # the kernel launches are the two prefills')
    for path in SPEC_PATHS[1:]:
        def run(path=path):
            getattr(spec, path)(prompt, SPEC_PROFILE_NEW)

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        r0 = spec.rounds
        prof = profile_step(run, wall_ms, f"spec {path}")
        rounds = spec.rounds - r0
        graphs = sum(v for k, v in prof["host_launch_calls"].items()
                     if "GraphLaunch" in k)
        res[path]["profile"] = prof
        res[path]["graph_launches_per_round"] = graphs / rounds
        log(f"[spec] {path}: {graphs} graph launches for {rounds} rounds "
            f"({graphs / rounds:.3f} a round)")
    del spec, greedy
    torch.cuda.empty_cache()

    # exactness: draft = target at 2 layers, float32, float KV caches.  One
    # round (k + 2 tokens: the prefill's, then k drafts and the target's)
    # must accept every draft on each loop: the draft's decode step and the
    # target's verify chunk agree.  Over 64 tokens the acceptance is lower,
    # as the JAX package's own algorithm has it: after a fully accepted
    # round the draft never saw its last draft token, so its cache lacks
    # that row (ROADMAP section 3); the tokens stay greedy's.
    scfg = TransformerConfig(**dict(LLM_CFG, layers=SPEC_SMALL_LAYERS))
    sparams = _first_layers(params, SPEC_SMALL_LAYERS)
    same = SpeculativeSession(scfg, scfg, params=sparams, draft_params=sparams,
                              k=SPEC_K)
    small = GenerationSession(scfg, batch=1, params=sparams,
                              prefill_buckets=False, device=same.device)
    exact = {}
    for n in (SPEC_K + 2, SPEC_NEW):
        want = small.generate(prompt, n)
        for path in SPEC_PATHS:
            r0, a0, p0 = same.rounds, same.drafts_accepted, same.drafts_proposed
            counted = n == SPEC_K + 2 and path == "generate"
            if counted:  # its two float32 prefills on the float32 flash route
                reset_counts()
            out = getattr(same, path)(prompt, n)
            if counted:
                torch.cuda.synchronize()
                f32_counts = read_counts()
                want_f32 = 2 * SPEC_SMALL_LAYERS
                log(f"[spec] draft = target, float32, one generate: launches "
                    f"{f32_counts}")
                if f32_counts != dict(no_launches(), flash_attention=want_f32,
                                      flash_attention_f32=want_f32):
                    raise AssertionError(f"expected {want_f32} float32 flash "
                                         f"launches, got {f32_counts}")
            rate = (same.drafts_accepted - a0) / (same.drafts_proposed - p0)
            row = exact.setdefault(f"{n}_tokens", {})[path] = dict(
                tokens_equal_greedy=bool(np.array_equal(out, want)),
                rounds=same.rounds - r0, acceptance_rate=rate)
            log(f"[spec] draft = target, {SPEC_SMALL_LAYERS} layers, float32, "
                f"{n} tokens: {path} tokens equal greedy "
                f"{row['tokens_equal_greedy']}, rounds {row['rounds']}, "
                f"acceptance {rate:.4f}")
            if not row["tokens_equal_greedy"]:
                raise AssertionError(f"{path}: draft = target differs from "
                                     f"greedy")
            if n == SPEC_K + 2 and (row["rounds"], rate) != (1, 1.0):
                raise AssertionError(f"{path}: draft = target did not accept "
                                     f"every draft of its one round")
            if rate < 0.5:  # the JAX package's own bound for draft = target
                raise AssertionError(f"{path}: draft = target accepted "
                                     f"{rate:.3f} of its drafts")
    res["draft_equals_target"] = exact
    res["draft_equals_target_launches"] = f32_counts
    report["speculative"] = res
    return f32_counts


# ------------------------------------------------- tuned long-context prefill

# the JAX suite's `bench_prefill_longctx` (`tools/bench_suite.py:273-306`)
LONGCTX_CFG = dict(vocab=8000, embed=1024, heads=8, kv_heads=8, layers=4,
                   max_seq=2048)
LONGCTX_BATCH = 2


def tuned_prefill_phase(report, card):
    """Phase 17: the long-context prefill (vocab 8000, E 1024, 8 heads, 4
    layers, b2, S 2048, a bf16 net) dense and tuned on the card, through
    what `optimize(autotune=True, tuner_cache=build/...)` runs (an
    `AutoTuner` on that cache and `autotune_graph`, so that its `timings`
    can be read): the choice per attention node and both candidates' times;
    a second tuner on the cache times nothing, and `optimize(autotune=True)`
    on it gives the same choices; each net's ms per batch, the flash
    launches of a tuned forward."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.kernels.autotune import AutoTuner, autotune_graph
    from anakin_tpu_torch.models import (TransformerConfig,
                                         build_transformer_lm,
                                         make_transformer_params)

    cfg = TransformerConfig(**LONGCTX_CFG)
    S = cfg.max_seq
    g = build_transformer_lm(cfg, batch=LONGCTX_BATCH, seq_len=S,
                             params=make_transformer_params(cfg, 0),
                             with_lengths=False)
    cache = os.path.join(ROOT, "build", "autotune_chip_smoke.json")
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    if os.path.exists(cache):
        os.remove(cache)
    t0 = time.perf_counter()
    tuner = AutoTuner(cache)
    reset_counts()
    tuned = autotune_graph(ak.optimize(g), tuner)
    tune_counts = read_counts()
    tune_s = time.perf_counter() - t0
    if not tune_counts["flash_attention_f32"] or tune_counts != dict(
            no_launches(), flash_attention=tune_counts["flash_attention_f32"],
            flash_attention_f32=tune_counts["flash_attention_f32"]):
        raise AssertionError(f"the tuning should launch the float32 flash "
                             f"route (its flash candidate) and nothing "
                             f"else: {tune_counts}")
    t0 = time.perf_counter()
    reread = AutoTuner(cache)
    again = autotune_graph(ak.optimize(g), reread)
    again_s = time.perf_counter() - t0
    if reread.timings:
        raise AssertionError(f"the second tuning timed again: "
                             f"{reread.timings}")
    # the entry point a user calls, on the same cache
    entry = ak.optimize(g, autotune=True, tuner_cache=cache)
    attn = [n for n in tuned.nodes.values() if n.op == "multi_head_attention"]
    impls = [n.attrs["impl"] for n in attn]
    for other in (again, entry):
        if [other.nodes[n.name].attrs["impl"] for n in attn] != impls:
            raise AssertionError("the cached decisions differ from the "
                                 "timed ones")
    if len(tuner.timings) != 1:
        raise AssertionError(f"expected one timed key (the four attention "
                             f"nodes share a shape), got {tuner.timings}")
    times = dict(next(iter(tuner.timings.values())))
    log(f"[tune] tuning {tune_s:.1f} s: candidates at "
        f"[{LONGCTX_BATCH}, {S}, {cfg.embed}] float32 (the tuner's operands) "
        f"{ {k: round(v, 4) for k, v in times.items()} } ms -> {impls[0]} "
        f"on all {len(attn)} attention nodes (margin 1.3); "
        f"{tune_counts['flash_attention_f32']} float32 flash launches; the "
        f"second tuner {again_s:.1f} s read the cache and timed nothing "
        f"| {card}")
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (LONGCTX_BATCH, S)).astype(np.int32)).cuda()
    res = dict(candidates_ms=times, impls=impls, tune_s=tune_s,
               cached_tune_s=again_s, tune_launches=tune_counts)
    logits = {}
    for name, graph in (("dense", ak.optimize(g)), ("tuned", tuned)):
        net = ak.Net(graph, precision="bf16")
        net.prediction({"input": x})
        reset_counts()
        wgmma0 = wgmma_flash_launches()
        y = net.prediction({"input": x})[graph.outputs[0]]
        torch.cuda.synchronize()
        counts = read_counts()
        want = len(attn) if name == "tuned" and impls[0] == "flash" else 0
        if counts != dict(no_launches(), flash_attention=want):
            raise AssertionError(f"{name}: expected {want} flash launches, "
                                 f"got {counts}")
        require_wgmma_flash(f"the {name} forward", counts,
                            wgmma_flash_launches() - wgmma0)
        if tuple(y.shape) != (LONGCTX_BATCH, S, cfg.vocab) or \
                not torch.isfinite(y.float()).all():
            raise AssertionError(f"{name}: bad logits {tuple(y.shape)}")
        logits[name] = y.float()
        ms = cuda_ms(lambda: net.prediction({"input": x}), iters=3, windows=3)
        res[name] = dict(ms_per_batch=ms, launches=counts,
                         tokens_per_s=LONGCTX_BATCH * S / ms * 1e3)
        log(f"[tune] prefill {name} b{LONGCTX_BATCH} x S{S} bf16: {ms:.3f} "
            f"ms/batch, {LONGCTX_BATCH * S / ms * 1e3:.0f} tokens/s, "
            f"launches {counts} | {card}")
        del net
    # the tuned net's logits against the dense net's (flash_wgmma against
    # the dense bf16 attention where the tuner took flash)
    scale = float(logits["dense"].abs().max())
    err = float((logits["tuned"] - logits["dense"]).abs().max())
    res["tuned_vs_dense"] = dict(max_abs_diff=err, rel_to_max=err / scale)
    log(f"[tune] tuned ({impls[0]}) against dense logits: max |diff| "
        f"{err:.4g} ({err / scale:.3g} of the largest, tolerance {LLM_TOL})")
    if err > LLM_TOL * scale:
        raise AssertionError(f"the tuned prefill's logits differ from the "
                             f"dense one's by {err / scale:.3g} of the largest")
    report["tuned_prefill"] = res
    return tune_counts


# ----------------------------------------------------------- CNN breadth

# int8 kernel launches of one forward at 224 px
CNN_ROUTES = {
    "vgg16": dict(conv3x3_int8=13, matmul_int8=3),
    "googlenet": dict(conv3x3_int8=10, matmul_int8=47),
    "shufflenet_v1": dict(depthwise3x3_int8=16, matmul_int8=95),
}
# (net, precision, batch): the JAX suite's `vgg16_int8_b8` and
# `googlenet_bf16_b8` (`tools/bench_suite.py:500-519`), GoogLeNet int8 at
# the same batch, ShuffleNet v1 (groups 3) int8 at the MobileNet batch
CNN_RUNS = (("vgg16", "int8", 8), ("googlenet", "bf16", 8),
            ("googlenet", "int8", 8), ("shufflenet_v1", "int8", BATCH))


def cnn_graph(name, batch, size=IMAGE, scales=None):
    """The optimized graph of `name`, quantized with `scales` if given."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch import models
    from anakin_tpu_torch.quant import quantize_graph

    g = ak.optimize(getattr(models, "build_" + name)(batch=batch,
                                                     image_size=size))
    return g if scales is None else quantize_graph(g, scales)


def cnn_scales(name, device=None):
    """`calibrate(method="max")` of the b1 graph over two b1 batches from
    default_rng(0), as the MobileNet phase calibrates."""
    from anakin_tpu_torch.quant import calibrate

    rng = np.random.default_rng(0)
    cal = [{"input": rng.normal(size=(1, IMAGE, IMAGE, 3)).astype(np.float32)}
           for _ in range(2)]
    return calibrate(cnn_graph(name, 1), cal, method="max", device=device)


def cnn_path(name, precision, batch, scales, report, card):
    """One CNN run of phase 18: one forward with the counts set to 0 just
    before and read just after (the int8 nets' kernels, exactly), the
    softmax rows, ms/step, img/s and a profiled step.  Returns the int8
    kernel calls of one forward, for the checks."""
    import anakin_tpu_torch as ak

    t0 = time.perf_counter()
    g = cnn_graph(name, batch, scales=None if precision == "bf16" else scales)
    net = ak.Net(g, precision="bf16")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(batch, IMAGE, IMAGE, 3)).astype(np.float32)).cuda()
    net.prediction({"input": x})                   # warm-up
    torch.cuda.synchronize()
    tag = f"{name} {precision}"
    log(f"[cnn] {tag}: graph, weights and first forward "
        f"{time.perf_counter() - t0:.1f} s")
    reset_counts()
    y = net.prediction({"input": x})[g.outputs[0]]
    torch.cuda.synchronize()
    counts = read_counts()
    want = CNN_ROUTES[name] if precision == "int8" else {}
    if counts != dict(no_launches(), **want):
        raise AssertionError(f"{tag}: expected {want} launches, got {counts}")
    yf = y.float()
    if tuple(y.shape) != (batch, 1000) or not torch.isfinite(yf).all():
        raise AssertionError(f"{tag}: bad output {tuple(y.shape)}")
    if (yf.sum(-1) - 1).abs().max() > 2e-2:  # bf16 softmax rows
        raise AssertionError(f"{tag}: softmax rows do not sum to 1")
    step_ms = cuda_ms(lambda: net.prediction({"input": x}), iters=5,
                      windows=3)
    res = dict(batch=batch, image=IMAGE, net_precision="bf16",
               weights=precision, launches=counts, ms_per_step=step_ms,
               img_per_s=batch / step_ms * 1e3)
    log(f"[cnn] {tag} b{batch} {IMAGE}px: {step_ms:.3f} ms/step, "
        f"{batch / step_ms * 1e3:.1f} img/s; launches {counts} | {card}")
    res["profile"] = profile_step(lambda: net.prediction({"input": x}),
                                  step_ms, f"cnn {tag}")
    report.setdefault("cnn", {})[f"{name}_{precision}_b{batch}"] = res
    return cnn_calls(g) if precision == "int8" else []


def cnn_calls(g):
    """The int8 kernel calls of one forward of `g`, its edge shapes from
    shape inference (no forward needed)."""
    from anakin_tpu_torch.graph.shape_infer import infer_shapes

    return kernel_calls(g, {k: tuple(v.shape)
                            for k, v in infer_shapes(g).items()})


def cnn_kernel_checks(report, calls, key="cnn_kernel_checks", tag="cnn",
                      exact=False):
    """Every distinct int8 kernel shape of the paths in `calls` (by net)
    against its plain version on the card, untimed: int8 outputs equal,
    float outputs within rtol 1e-6, or bit-equal with `exact`.  The rows
    go to `report[key]`."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    distinct = {}
    for net_calls in calls.values():
        for kernel, cfg in net_calls:
            distinct.setdefault(
                (kernel, tuple(sorted(cfg.items(), key=lambda kv: kv[0]))), 0)
    results = []
    for kernel, items in distinct:
        cfg = dict(items)
        r = (check_dw(cfg, gen, timed=False) if kernel == "depthwise3x3_int8"
             else check_kernel(kernel, cfg, gen, timed=False))
        if exact:
            r["ok"] = r["ok"] and r["max_abs_err"] == 0
        r["calls_per_run"] = 0  # the kernels line's runs are the ResNet's
        results.append(r)
    by_kernel = {}
    for r in results:
        by_kernel.setdefault(r["kernel"], []).append(r)
    for kernel, rs in by_kernel.items():
        log(f"[{tag} kernels] {kernel}: {len(rs)} distinct shapes, max abs err "
            f"{max(r['max_abs_err'] for r in rs):g}; e.g. " + "; ".join(
                "x".join(str(r[k]) for k in (
                    ("N", "H", "W", "C") if kernel != "matmul_int8"
                    else ("M", "K", "N"))) for r in rs[:6]))
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel differs from its plain version: {bad}")
    report[key] = [
        {k: v for k, v in r.items() if k not in ("ms", "plain_ms",
                                                 "library_ms")}
        for r in results]
    return results


# card against CPU, a float32 ResNet-50 of conv2d_w8 nodes: cuDNN's and
# oneDNN's float32 convolutions sum in other orders through 53 layers
W8_LOGIT_TOL = 1e-3


def cnn_cpu_gpu(report):
    """The CNNs at b2, 64 px, card against CPU, node by node on the CPU's
    inputs (int8 kernel outputs equal, other int8 outputs within 1 LSB,
    float outputs within 8e-3); then a `conv2d_w8` ResNet-50
    (`weight_only_quantize(bits=8)`) at b2, 64 px in float32 (logits
    within W8_LOGIT_TOL of the largest), GoogLeNet after
    `horizontal_combine` equal to the uncombined graph on the card (within
    1e-4 of each output's largest value: cuDNN picks its own algorithm for
    the wider conv), and a `moe_ffn` node card against CPU (within 1e-5 of
    the largest value)."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.graph.ir import Node
    from anakin_tpu_torch.graph.passes import horizontal_combine
    from anakin_tpu_torch.models import build_resnet50
    from anakin_tpu_torch.ops import get_op
    from anakin_tpu_torch.quant import calibrate, weight_only_quantize

    x2 = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    res = {}
    for name in CNN_ROUTES:
        g = cnn_graph(name, 2, size=64)
        gq = cnn_graph(name, 2, size=64, scales=calibrate(
            g, [{"input": x2}], method="max", device="cpu"))
        edges = [e for n in gq.nodes.values() for e in n.outputs]
        y_cpu = ak.Net(gq, "bf16", device="cpu", tap_edges=edges).prediction(
            {"input": x2})
        kernel_lsb, other_lsb, float_rel = _node_by_node(gq, x2, y_cpu)
        res[name] = dict(node_kernel_max_lsb=kernel_lsb,
                         node_other_max_lsb=other_lsb,
                         node_float_max_rel=float_rel)
        log(f"[cpu/gpu {name}] b2 64px node by node on the CPU's inputs: int8 "
            f"kernel outputs max diff {kernel_lsb} LSB, other int8 outputs "
            f"{other_lsb} LSB, float outputs max rel diff {float_rel:.3g}")
        if kernel_lsb or other_lsb > 1 or float_rel > 8e-3:
            raise AssertionError(f"{name}: a node differs between the card "
                                 f"and the CPU on the same inputs")

    gw = weight_only_quantize(ak.optimize(build_resnet50(batch=2,
                                                         image_size=64)),
                              bits=8)
    n_w8 = sum(n.op == "conv2d_w8" for n in gw.nodes.values())
    logits = next(n.outputs[0] for n in gw.nodes.values()
                  if n.op == "dense_w8")
    lg = ak.Net(gw, tap_edges=[logits]).prediction({"input": x2})[
        logits].cpu()
    lc = ak.Net(gw, device="cpu", tap_edges=[logits]).prediction(
        {"input": x2})[logits]
    err = float((lg - lc).abs().max() / lc.abs().max())
    log(f"[cpu/gpu w8] ResNet-50 weight-only int8 ({n_w8} conv2d_w8 nodes) "
        f"b2 64px float32: logits max diff {err:.3g} of the largest "
        f"(tolerance {W8_LOGIT_TOL:g}), top-1 gpu {lg.argmax(-1).tolist()} "
        f"cpu {lc.argmax(-1).tolist()}")
    if not n_w8 or err > W8_LOGIT_TOL:
        raise AssertionError(f"conv2d_w8: card and CPU logits differ by {err}")
    res["conv2d_w8_logits_max_rel"] = err

    g = cnn_graph("googlenet", 2, size=64)
    gc = horizontal_combine(g)
    n_slice = sum(n.op == "slice" for n in gc.nodes.values())
    if n_slice != 9:
        raise AssertionError(f"horizontal_combine made {n_slice} slices")
    taps = [n.outputs[0] for n in g.nodes.values() if n.op == "concat"]
    ya = ak.Net(gc, tap_edges=taps).prediction({"input": x2})
    yb = ak.Net(g, tap_edges=taps).prediction({"input": x2})
    comb = max(float((ya[e] - yb[e]).abs().max() / yb[e].abs().max())
               for e in taps + list(g.outputs))
    log(f"[cpu/gpu combine] GoogLeNet b2 64px float32 on the card, "
        f"horizontal_combine ({n_slice} slices) against the uncombined "
        f"graph: max diff {comb:.3g} of each output's largest")
    if comb > 1e-4:
        raise AssertionError(f"horizontal_combine changed the outputs: {comb}")
    res["horizontal_combine_max_rel"] = comb

    rng = np.random.default_rng(5)
    ins = [rng.normal(size=(2, 16, 64)).astype(np.float32),
           rng.normal(size=(64, 8)).astype(np.float32),
           rng.normal(size=(8, 64, 128)).astype(np.float32) * 0.1,
           rng.normal(size=(8, 128, 64)).astype(np.float32) * 0.1]
    node = Node("moe", "moe_ffn", ["x", "g", "u", "d"], ["y"],
                dict(top_k=2, activation="gelu"))
    ts = [torch.from_numpy(a) for a in ins]
    yc = get_op("moe_ffn")(node, ts)[0]
    yg = get_op("moe_ffn")(node, [t.cuda() for t in ts])[0].cpu()
    moe = float((yg - yc).abs().max() / yc.abs().max())
    log(f"[cpu/gpu moe] moe_ffn [2, 16, 64] x 8 experts top 2, float32: max "
        f"diff {moe:.3g} of the largest")
    if moe > 1e-5:
        raise AssertionError(f"moe_ffn card and CPU differ: {moe}")
    res["moe_ffn_max_rel"] = moe
    report["cnn_cpu_gpu"] = res


def cnn_phases(report, card):
    """Phase 18: calibrate each CNN on the card, the four runs, every
    distinct int8 kernel shape checked, then card against CPU.  Returns
    the kernel check rows."""
    t0 = time.perf_counter()
    scales = {name: cnn_scales(name) for name in CNN_ROUTES}
    log(f"[cnn] calibrate on the card: {time.perf_counter() - t0:.1f} s")
    calls = {}
    for name, precision, batch in CNN_RUNS:
        got = cnn_path(name, precision, batch, scales[name], report, card)
        if got:
            calls[f"{name}_{precision}"] = got
    log(f"[time] phase 18 runs done at {time.perf_counter() - t0:.0f} s")
    results = cnn_kernel_checks(report, calls)
    log(f"[time] phase 18 kernel checks done at "
        f"{time.perf_counter() - t0:.0f} s")
    cnn_cpu_gpu(report)
    log(f"[time] phase 18 took {time.perf_counter() - t0:.0f} s")
    return results


# ------------------------------------------------------------- detection

# the JAX suite's detection nets, b1 at full width (`tools/bench_suite.py:
# 506-510, 533-561`): SSD300-VGG16 (21 classes), YOLOv3-tiny at 416 px (80
# classes), Faster R-CNN (ResNet-50-C4, base_width 64, pre 1024 / post 128
# proposals, roi_align 14 x 14) at 224 px; each in bf16 and int8 (the suite
# runs SSD in bf16 only)
DET_NETS = {"ssd_vgg16": 300, "yolo_v3_tiny": 416, "faster_rcnn": 224}
# card against CPU at b1, full width, a cut image size (SSD's extra layers
# need 257 px or more) and, for Faster R-CNN, 16 proposals from the top 256
# in place of 128 from 1024 (the CPU's int8 plain versions accumulate in
# int64 without BLAS: 128 ROIs through stage 4 take minutes there)
DET_CPU_CUTS = {"ssd_vgg16": (264, {}), "yolo_v3_tiny": (128, {}),
                "faster_rcnn": (128, dict(pre_nms_top_n=256,
                                          post_nms_top_n=16))}
# a detection op on the card against the CPU on the same inputs: the
# decode's `exp` and the IoU round their last bits apart (relative to the
# slab's largest value)
DET_SLAB_RTOL = 1e-5
DET_SLAB_OPS = ("detection_output", "rcnn_detection_output")
DET_PROPOSAL_OPS = ("generate_proposals",)


def det_graph(name, size, scales=None, **kw):
    """The optimized b1 graph of `name` at `size` px (builder arguments
    `kw`), quantized with `scales` if given."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch import models
    from anakin_tpu_torch.quant import quantize_graph

    g = ak.optimize(getattr(models, "build_" + name)(batch=1,
                                                     image_size=size, **kw))
    return g if scales is None else quantize_graph(g, scales)


def det_feed(name, size, rng):
    """A b1 feed: the image from `rng` and the net's image-size input."""
    feed = {"input": rng.normal(size=(1, size, size, 3)).astype(np.float32)}
    if name == "yolo_v3_tiny":
        feed["img_size"] = np.array([[size, size]], np.int32)
    elif name == "faster_rcnn":
        feed["im_info"] = np.array([[size, size, 1.0]], np.float32)
    return feed


def det_scales(name, size, device=None):
    """`calibrate(method="max")` of the b1 graph over two b1 feeds from
    default_rng(0), as the JAX suite calibrates its detectors."""
    from anakin_tpu_torch.quant import calibrate

    rng = np.random.default_rng(0)
    return calibrate(det_graph(name, size),
                     [det_feed(name, size, rng) for _ in range(2)],
                     method="max", device=device)


def det_slab_rows(slab, valid_col=2):
    """(valid mask, valid rows) of a [B, K, 7] slab (score > 0) or of
    proposals [B, R, 5] (corners not all -1), on the host."""
    s = slab.float().cpu()
    valid = (s[..., valid_col] > 0 if s.shape[-1] == 7
             else ~(s[..., 1:] == -1).all(-1))
    return valid, s[valid]


def det_check_outputs(name, g, out, size, tag):
    """The outputs a detector must give: finite, of the expected shapes;
    a slab's valid rows hold image 0, a label in 1..C-1, a score in
    (0, 1] and finite corners, its other rows -1; YOLO's boxes lie in the
    image and its scores in [0, 1].  Returns the valid rows' count."""
    outs = [out[e] for e in g.outputs]
    for o in outs:
        if not torch.isfinite(o.float()).all():
            raise AssertionError(f"{tag}: a non-finite output")
    if name == "yolo_v3_tiny":
        # the clip's bound size - 1 as the boxes' dtype holds it (415 is
        # 416 in bf16)
        top = float(torch.tensor(size - 1.0).to(outs[0].dtype))
        boxes, scores = (o.float() for o in outs)
        n = 3 * ((size // 32) ** 2 + (size // 16) ** 2)
        if tuple(boxes.shape) != (1, n, 4) or tuple(scores.shape) != (1, n, 80):
            raise AssertionError(f"{tag}: shapes {boxes.shape} {scores.shape}")
        if boxes.min() < 0 or boxes.max() > top or scores.min() < 0 \
                or scores.max() > 1:
            raise AssertionError(f"{tag}: boxes or scores out of range")
        return int((scores > 0).any(-1).sum())
    slab = outs[0]
    n_cls, keep = (21, 200) if name == "ssd_vgg16" else (21, 100)
    if tuple(slab.shape) != (1, keep, 7):
        raise AssertionError(f"{tag}: slab shape {tuple(slab.shape)}")
    valid, rows = det_slab_rows(slab)
    s = slab.float().cpu()
    if not ((s[~valid][:, 1:] == -1).all() and (rows[:, 0] == 0).all()
            and (rows[:, 1] >= 1).all() and (rows[:, 1] <= n_cls - 1).all()
            and (rows[:, 2] <= 1).all()):
        raise AssertionError(f"{tag}: a malformed slab")
    if name == "faster_rcnn" and tuple(outs[1].shape) != (128, n_cls):
        raise AssertionError(f"{tag}: cls_prob shape {tuple(outs[1].shape)}")
    return int(valid.sum())


def det_path(name, precision, scales, report, card):
    """One detector run of phase 19: one b1 forward with the counts set to
    0 just before and read just after (an int8 net's conv3x3_int8 and
    matmul_int8 calls exactly, a bf16 net none), its outputs checked,
    ms/step, a profiled step (device busy share, kernel launches a step),
    then the forward captured by `Net.compile`: outputs equal to the eager
    forward's, ms/step of the replay.
    Returns the int8 kernel calls of one forward, for the checks."""
    import anakin_tpu_torch as ak

    size = DET_NETS[name]
    t0 = time.perf_counter()
    g = det_graph(name, size, scales=None if precision == "bf16" else scales)
    # Faster R-CNN's proposals: how many rows NMS left empty (ROADMAP §3
    # item 13: the second stage does not take them as invalid)
    rois = [n.outputs[0] for n in g.nodes.values()
            if n.op == "generate_proposals"]
    net = ak.Net(g, precision="bf16", tap_edges=rois)
    feed = {k: torch.from_numpy(v).cuda()
            for k, v in det_feed(name, size, np.random.default_rng(1)).items()}
    net.prediction(feed)                           # warm-up
    torch.cuda.synchronize()
    tag = f"{name} {precision}"
    log(f"[det] {tag}: graph, weights and first forward "
        f"{time.perf_counter() - t0:.1f} s")
    calls = cnn_calls(g) if precision == "int8" else []
    want = {}
    for kernel, _ in calls:
        want[kernel] = want.get(kernel, 0) + 1
    reset_counts()
    out = net.prediction(feed)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != dict(no_launches(), **want):
        raise AssertionError(f"{tag}: expected {want} launches, got {counts}")
    n_valid = det_check_outputs(name, g, out, size, tag)
    empty = [int((~det_slab_rows(out[e])[0]).sum()) for e in rois]
    step_ms = cuda_ms(lambda: net.prediction(feed), iters=5, windows=3)
    prof = profile_step(lambda: net.prediction(feed), step_ms, f"det {tag}")
    # the same forward captured in one CUDA graph (`Net.compile`): the
    # heads read nothing on the host, so it captures; its outputs must
    # equal the eager forward's
    step = net.compile(feed)
    cap = step(feed)
    torch.cuda.synchronize()
    if not all(torch.equal(cap[e], out[e]) for e in g.outputs):
        raise AssertionError(f"{tag}: the captured forward differs from "
                             f"the eager one")
    captured_ms = cuda_ms(lambda: step(feed), iters=10, windows=3)
    del step, cap
    shapes = {}
    for kernel, cfg in calls:
        shapes.setdefault(kernel, set()).add(tuple(sorted(cfg.items())))
    per_kernel = {k: dict(calls=want[k], distinct_shapes=len(v))
                  for k, v in shapes.items()}
    log(f"[det] {tag} b1 {size}px: {step_ms:.3f} ms/step eager, "
        f"{captured_ms:.3f} captured, device busy "
        f"{100 * prof['busy_share_of_step']:.1f}% (eager), "
        f"{prof['kernel_launches']} kernel launches a step; int8 kernels "
        f"{per_kernel}; {n_valid} valid detections"
        + (f", {empty[0]} empty proposal rows" if empty else "")
        + f" | {card}")
    report.setdefault("detection", {})[f"{name}_{precision}_b1"] = dict(
        image=size, net_precision="bf16", weights=precision, launches=counts,
        int8_kernels=per_kernel, ms_per_step=step_ms,
        captured_ms_per_step=captured_ms, valid=n_valid,
        empty_proposal_rows=empty, profile=prof)
    return calls


def int8_node_by_node(gq, taps, what):
    """Each node of the bf16 int8 net `gq` on the card, fed the CPU net's
    values of its inputs, against the CPU net's values of its outputs: the
    int8 kernels' outputs (conv2d_int8, dense_int8; int8 or float) and
    integer outputs (labels, tags) equal, other int8 outputs within 1 LSB,
    detection slabs and proposals valid on the same rows within
    DET_SLAB_RTOL of their largest value, float outputs within 8e-3 of
    their largest (bf16 rounding after sums in other orders).  Returns the
    largest of each."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.graph.ir import topological_order
    from anakin_tpu_torch.runtime.net import build_forward

    net = ak.Net(gq, "bf16")
    worst = dict(other_lsb=0, slab_rel=0.0, float_rel=0.0)
    for node in topological_order(gq):
        fwd, _ = build_forward(gq, "bf16", start_from=node.name,
                               stop_at=node.name)
        feed = {e: taps[e].cuda() for e in node.inputs if e not in gq.params}
        with torch.inference_mode():
            ys = fwd(net.params, feed, net.prepared)
        for e in node.outputs:
            a, b = ys[e].cpu(), taps[e]
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"{what} {node.name}: {a.dtype} "
                                     f"{tuple(a.shape)} vs {b.dtype} "
                                     f"{tuple(b.shape)}")
            if node.op in DET_SLAB_OPS + DET_PROPOSAL_OPS:
                rows, _, d = det_slab_diff(a, b)
                if not rows:
                    raise AssertionError(f"{what} {node.name}: other valid "
                                         f"rows on the card")
                worst["slab_rel"] = max(worst["slab_rel"], d)
            elif (node.op in ("conv2d_int8", "dense_int8")
                  or not b.is_floating_point() and b.dtype != torch.int8):
                if not torch.equal(a, b):
                    raise AssertionError(f"{what} {node.name} ({node.op}): "
                                         f"{e} differs")
            elif b.dtype == torch.int8:
                worst["other_lsb"] = max(worst["other_lsb"],
                                         int((a.int() - b.int()).abs().max()))
            else:
                d = float((a.float() - b.float()).abs().max()
                          / b.float().abs().max().clamp_min(1e-30))
                worst["float_rel"] = max(worst["float_rel"], d)
    if (worst["other_lsb"] > 1 or worst["slab_rel"] > DET_SLAB_RTOL
            or worst["float_rel"] > 8e-3):
        raise AssertionError(f"{what}: a node differs between the card and "
                             f"the CPU on the same inputs: {worst}")
    return worst


def det_slab_diff(a, b):
    """Slabs or proposals a (card) against b (CPU): (the same valid rows,
    their image and label columns equal, the rows' largest difference
    relative to b's largest value)."""
    va, ra = det_slab_rows(a)
    vb, rb = det_slab_rows(b)
    if not torch.equal(va, vb):
        return False, False, float("inf")
    ids = 2 if a.shape[-1] == 7 else 1
    rel = float((ra - rb).abs().max() / b.float().abs().max()
                .clamp_min(1e-30)) if len(rb) else 0.0
    return True, torch.equal(ra[:, :ids], rb[:, :ids]), rel


def det_edge_diff(op, a, b):
    """How edge a (card) parts from b (CPU): (parts at all, the measure, a
    float output's difference relative to its largest value or None)."""
    a = a.cpu()
    if op in DET_SLAB_OPS + DET_PROPOSAL_OPS:
        rows, ids, rel = det_slab_diff(a, b)
        if not rows:
            return True, "other rows valid", None
        return rel > 0 or not ids, \
            f"the same {int(det_slab_rows(b)[0].sum())} valid rows, ids " \
            f"{'equal' if ids else 'differ'}, values max rel diff {rel:.3g}", \
            None
    if b.dtype == torch.int8:
        d = (a.int() - b.int()).abs()
        return bool(d.any()), f"{int(d.max())} LSB at {int((d > 0).sum())} " \
            f"of {d.numel()}", None
    if b.is_floating_point():
        rel = float((a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp_min(1e-30))
        return rel > 0, f"max rel diff {rel:.3g}", rel
    same = torch.equal(a, b)
    return not same, "equal" if same else "differs", None


def det_first_parting(nodes, taps_gpu, taps_cpu):
    """Walk `nodes` in order, card against CPU on each run's own values:
    the first node whose output parts at all, and the first whose float
    output parts by more than the tolerance `int8_node_by_node` holds float
    nodes to on shared inputs (8e-3 of the largest value): (name, op,
    edge, measure) of each, or None."""
    first_any = first_float = None
    for node in nodes:
        for e in node.outputs:
            parts, what, rel = det_edge_diff(node.op, taps_gpu[e], taps_cpu[e])
            if parts and first_any is None:
                first_any = (node.name, node.op, e, what)
            if rel is not None and rel > 8e-3 and first_float is None:
                first_float = (node.name, node.op, e, what)
    return first_any, first_float


def det_from_cut(gq, order, cut, feed, taps_cpu):
    """The card's net from node `cut` on, fed the CPU's values of every
    edge made before the cut and read after it (the int8 edges among them
    shared, as phase 11 shares MobileNet's stem output): whether the slabs
    keep the CPU's rows, and the first node of the tail that parts."""
    import anakin_tpu_torch as ak

    made = {e for n in order[:cut] for e in n.outputs} | set(feed)
    frontier = {e for n in order[cut:] for e in n.inputs if e in made}
    tail = [e for n in order[cut:] for e in n.outputs]
    out = ak.Net(gq, "bf16", start_from=order[cut].name,
                 tap_edges=tail).prediction(
        {e: taps_cpu[e] for e in frontier})
    first_any, _ = det_first_parting(order[cut:], out, taps_cpu)
    slabs = {e: det_edge_diff(n.op, out[e], taps_cpu[e])[1]
             for n in order[cut:] if n.op in DET_SLAB_OPS for e in n.outputs}
    return dict(cut_at=order[cut].name, shared_edges=len(frontier),
                tail_first_parting=first_any, slabs=slabs)


def det_cpu_gpu(report):
    """The three int8 detectors at b1 and their cuts (DET_CPU_CUTS), card
    against CPU: calibrated on the CPU, every node on the card fed the CPU
    net's inputs (`int8_node_by_node`); then the whole net from the image
    on both devices: the same valid slab rows with the same image and
    label, the values within DET_SLAB_RTOL of the largest; node by node on
    each device's own values from the image, the first node that parts
    and the first whose float output parts beyond the float nodes'
    tolerance (reported); then the net again from just after the first
    node that parts, every edge made before it shared from the CPU
    (`det_from_cut`, reported)."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.graph.ir import topological_order
    from anakin_tpu_torch.quant import calibrate, quantize_graph

    res = {}
    for name, (size, kw) in DET_CPU_CUTS.items():
        t0 = time.perf_counter()
        feed = det_feed(name, size, np.random.default_rng(2))
        g = det_graph(name, size, **kw)
        gq = quantize_graph(g, calibrate(g, [feed], method="max",
                                         device="cpu"))
        edges = [e for n in topological_order(gq) for e in n.outputs]
        taps = ak.Net(gq, "bf16", device="cpu", tap_edges=edges).prediction(
            feed)
        taps.update({k: torch.from_numpy(v) for k, v in feed.items()})
        worst = int8_node_by_node(gq, taps, f"{name} {size}px")
        order = topological_order(gq)
        out = ak.Net(gq, "bf16", tap_edges=edges).prediction(feed)
        first_any, first_float = det_first_parting(order, out, taps)
        from_cut = None
        if first_any is not None:
            cut = next(i for i, n in enumerate(order) if n.name == first_any[0])
            if cut + 1 < len(order):
                from_cut = det_from_cut(gq, order, cut + 1, feed, taps)
        whole = {}
        for e in gq.outputs:
            node = next(n for n in gq.nodes.values() if e in n.outputs)
            if node.op in DET_SLAB_OPS:
                rows, ids, rel = det_slab_diff(out[e].cpu(), taps[e])
                whole[e] = dict(same_rows=rows, ids_equal=ids,
                                values_max_rel=rel)
                if not (rows and ids and rel <= DET_SLAB_RTOL):
                    raise AssertionError(f"{name}: from the image, the card's "
                                         f"slab parts from the CPU's: "
                                         f"{whole[e]}")
            else:
                whole[e] = float((out[e].cpu().float() - taps[e].float())
                                 .abs().max() / taps[e].float().abs().max()
                                 .clamp_min(1e-30))
        res[name] = dict(size=size, cut=kw, node_by_node=worst,
                         whole_net=whole, from_image_first_parting=first_any,
                         from_image_first_float_beyond_tol=first_float,
                         from_cut=from_cut)
        log(f"[cpu/gpu det] {name} int8 b1 {size}px node by node on the "
            f"CPU's inputs: {worst}; whole net from the image: {whole} "
            f"({time.perf_counter() - t0:.1f} s)")
        log(f"[cpu/gpu det] {name} from the image, each device on its own "
            f"values: first node that parts {first_any}; first float output "
            f"beyond 8e-3 of its largest {first_float}; from just after the "
            f"first, every earlier edge shared from the CPU: {from_cut}")
    report["det_cpu_gpu"] = res


def det_phase(report, card):
    """Phase 19: calibrate each detector on the card, the six runs (bf16
    and int8), every distinct int8 kernel shape bit-equal to its plain
    version, then card against CPU.  Returns the int8 runs' kernel calls
    by net."""
    t0 = time.perf_counter()
    scales = {name: det_scales(name, size) for name, size in DET_NETS.items()}
    log(f"[det] calibrate on the card: {time.perf_counter() - t0:.1f} s")
    calls = {}
    for name in DET_NETS:
        for precision in ("bf16", "int8"):
            got = det_path(name, precision, scales[name], report, card)
            if got:
                calls[f"{name}_int8"] = got
    log(f"[time] phase 19 runs done at {time.perf_counter() - t0:.0f} s")
    cnn_kernel_checks(report, calls, key="det_kernel_checks", tag="det",
                      exact=True)
    log(f"[time] phase 19 kernel checks done at "
        f"{time.perf_counter() - t0:.0f} s")
    det_cpu_gpu(report)
    log(f"[time] phase 19 took {time.perf_counter() - t0:.0f} s")
    return calls


# ---------------------------------------------------------- segmentation

# the builders' defaults: b1, 64 px (FCN-8s lite 21 classes, ICNet lite 19)
SEG_NETS = {"fcn8s_lite": 21, "icnet_lite": 19}   # name -> classes
# float32 logits card against CPU, of the largest: cuDNN's and oneDNN's
# float32 convolutions sum in other orders through up to 9 layers
SEG_LOGIT_TOL = 1e-4


def seg_phase(report, card):
    """Phase 20: FCN-8s lite and ICNet lite at their defaults, float32 and
    bf16, on the card: no int8 kernel launches (they have no int8 route),
    ms/step; card against CPU: the float32 logits within SEG_LOGIT_TOL of
    the largest and the label maps equal where a pixel's two largest
    logits are apart by more than that; the bf16 net node by node on the
    CPU's inputs (float outputs within 8e-3 of their largest, the label
    map equal)."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch import models
    from anakin_tpu_torch.graph.ir import topological_order
    from anakin_tpu_torch.runtime.net import build_forward

    t0 = time.perf_counter()
    res = {}
    for name in SEG_NETS:
        g = ak.optimize(getattr(models, "build_" + name)())
        size = g.input_specs["input"][0][1]
        x = np.random.default_rng(3).normal(size=(1, size, size, 3)).astype(
            np.float32)
        logits_e, labels_e = g.outputs
        r = {}
        for precision in ("fp32", "bf16"):
            net = ak.Net(g, precision=precision)
            xc = torch.from_numpy(x).cuda()
            net.prediction({"input": xc})
            reset_counts()
            out = net.prediction({"input": xc})
            torch.cuda.synchronize()
            if read_counts() != no_launches():
                raise AssertionError(f"{name}: a kernel launched")
            if (tuple(out[logits_e].shape) != (1, size, size, SEG_NETS[name])
                    or tuple(out[labels_e].shape) != (1, size, size, 1)
                    or not torch.isfinite(out[logits_e].float()).all()):
                raise AssertionError(f"{name} {precision}: bad logits")
            ms = cuda_ms(lambda: net.prediction({"input": xc}), iters=5,
                         windows=3)
            edges = [e for n in topological_order(g) for e in n.outputs]
            cpu = ak.Net(g, precision=precision, device="cpu",
                         tap_edges=edges).prediction({"input": x})
            if precision == "fp32":
                lg, lc = out[logits_e].cpu(), cpu[logits_e]
                err = float((lg - lc).abs().max() / lc.abs().max())
                top2 = torch.topk(lc, 2, dim=-1).values
                clear = (top2[..., 0] - top2[..., 1]) > SEG_LOGIT_TOL * float(
                    lc.abs().max())
                same = bool(torch.equal(out[labels_e].cpu()[..., 0][clear],
                                        cpu[labels_e][..., 0][clear]))
                r[precision] = dict(ms_per_step=ms, logits_max_rel=err,
                                    labels_equal_where_clear=same,
                                    clear_share=float(clear.float().mean()))
                if err > SEG_LOGIT_TOL or not same:
                    raise AssertionError(f"{name} fp32: card and CPU differ: "
                                         f"{r[precision]}")
            else:
                worst = 0.0
                for node in topological_order(g):
                    fwd, _ = build_forward(g, "bf16", start_from=node.name,
                                           stop_at=node.name)
                    feed = {e: (cpu[e] if e in cpu else torch.from_numpy(x))
                            .cuda() for e in node.inputs if e not in g.params}
                    with torch.inference_mode():
                        a = fwd(net.params, feed)[node.outputs[0]].cpu()
                    b = cpu[node.outputs[0]]
                    if node.op == "argmax":
                        if not torch.equal(a, b):
                            raise AssertionError(f"{name} bf16: labels differ"
                                                 f" on the same logits")
                        continue
                    worst = max(worst, float((a.float() - b.float()).abs().max()
                                             / b.float().abs().max()))
                r[precision] = dict(ms_per_step=ms, node_float_max_rel=worst)
                if worst > 8e-3:
                    raise AssertionError(f"{name} bf16: a node differs: {worst}")
            log(f"[seg] {name} {precision} b1 {size}px: {ms:.3f} ms/step; card "
                f"vs CPU {r[precision]} | {card}")
        res[name] = r
    report["segmentation"] = res
    log(f"[time] phase 20 took {time.perf_counter() - t0:.0f} s")


# ------------------------------------------------------------------- RNNs

# the JAX suite's LSTM language model (`tools/bench_suite.py:564-567`,
# `lstm_lm_bf16_b8xT64`: `build_lstm_lm`'s defaults, vocab 10,000, E 256,
# H 512, 2 layers, seed 0) at b8 x T64, every length 64; the BiLSTM text
# classifier (vocab 5,000, E 128, H 128, 2 classes) and the BiGRU-CRF
# tagger (vocab 8,000, E 128, H 256, 9 tags) at the defaults of
# `build_text_classifier` and `build_ner_tagger`
RNN_NETS = {"lstm_lm": (8, 64), "text_classifier": (4, 64),
            "ner_tagger": (4, 48)}                 # name -> (batch, T)
RNN_VOCAB = {"lstm_lm": 10000, "text_classifier": 5000, "ner_tagger": 8000}
# card against CPU: full widths at b2 x T16, a cut so that the CPU's int8
# plain GEMM (int64, no BLAS) stays short; the second row of length 11
RNN_CPU_CUT = (2, 16)
# float32 nets card against CPU, of each edge's largest value: cuBLAS's and
# the CPU's float32 products sum in other orders, and the recurrence
# carries the difference through 16 steps and two layers
RNN_F32_TOL = 1e-5


def rnn_graph(name, batch, seq_len, scales=None):
    """The optimized graph of `name` at (batch, seq_len), quantized with
    `scales` if given."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch import models
    from anakin_tpu_torch.quant import quantize_graph

    g = ak.optimize(getattr(models, "build_" + name)(batch=batch,
                                                     seq_len=seq_len))
    return g if scales is None else quantize_graph(g, scales)


def rnn_feed(name, batch, seq_len, rng, lengths=None):
    """Token ids from `rng` and the lengths (all seq_len by default)."""
    return {"input": rng.integers(0, RNN_VOCAB[name], size=(batch, seq_len))
            .astype(np.int32),
            "lengths": (np.full((batch,), seq_len, np.int32) if lengths is None
                        else np.asarray(lengths, np.int32))}


def rnn_scales(name, device=None):
    """`calibrate(method="max")` of the phase-21 graph over two batches
    from default_rng(0), as the suite calibrates."""
    from anakin_tpu_torch.quant import calibrate

    b, t = RNN_NETS[name]
    rng = np.random.default_rng(0)
    return calibrate(rnn_graph(name, b, t),
                     [rnn_feed(name, b, t, rng) for _ in range(2)],
                     method="max", device=device)


def rnn_check_output(name, y, batch, seq_len, tag):
    """The LM's softmax [B, T, vocab] and the classifier's [B, 2]: finite
    rows summing to 1 (bf16); the tagger's tags [B, T] int32 in 0..8."""
    if name == "ner_tagger":
        if (y.dtype != torch.int32 or tuple(y.shape) != (batch, seq_len)
                or y.min() < 0 or y.max() > 8):
            raise AssertionError(f"{tag}: bad tags {y.dtype} {tuple(y.shape)}")
        return
    want = (batch, seq_len, RNN_VOCAB[name]) if name == "lstm_lm" else (batch, 2)
    yf = y.float()
    if tuple(y.shape) != want or not torch.isfinite(yf).all():
        raise AssertionError(f"{tag}: bad output {tuple(y.shape)}")
    if (yf.sum(-1) - 1).abs().max() > 2e-2:
        raise AssertionError(f"{tag}: softmax rows do not sum to 1")


def rnn_path(name, weights, scales, report, card):
    """One RNN run of phase 21: a bf16 net with float or int8 weights; one
    forward with the counts set to 0 just before and read just after
    (matmul_int8 once in an int8 net, nothing else; nothing in a float
    net), the output checked, eager ms/step, the forward captured by
    `Net.compile` (outputs equal to eager, ms/step replayed); for the LM
    tokens/s and a profiled eager and captured step (device busy share,
    kernel launches a step).  Returns the int8 kernel calls of one
    forward."""
    import anakin_tpu_torch as ak

    b, t = RNN_NETS[name]
    t0 = time.perf_counter()
    g = rnn_graph(name, b, t, scales if weights == "int8" else None)
    net = ak.Net(g, precision="bf16")
    feed = {k: torch.from_numpy(v).cuda()
            for k, v in rnn_feed(name, b, t, np.random.default_rng(1)).items()}
    net.prediction(feed)                           # warm-up
    torch.cuda.synchronize()
    tag = f"{name} {weights}"
    log(f"[rnn] {tag}: graph, weights and first forward "
        f"{time.perf_counter() - t0:.1f} s")
    calls = cnn_calls(g) if weights == "int8" else []
    want = {}
    for kernel, _ in calls:
        want[kernel] = want.get(kernel, 0) + 1
    reset_counts()
    out = net.prediction(feed)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != dict(no_launches(), **want) or (
            weights == "int8" and want != {"matmul_int8": 1}):
        raise AssertionError(f"{tag}: expected {want} launches, got {counts}")
    y = out[g.outputs[0]]
    rnn_check_output(name, y, b, t, tag)
    step_ms = cuda_ms(lambda: net.prediction(feed), iters=5, windows=3)
    step = net.compile(feed)
    cap = step(feed)
    torch.cuda.synchronize()
    if not torch.equal(cap[g.outputs[0]], y):
        raise AssertionError(f"{tag}: the captured forward differs from the "
                             f"eager one")
    captured_ms = cuda_ms(lambda: step(feed), iters=10, windows=3)
    res = dict(batch=b, seq_len=t, net_precision="bf16", weights=weights,
               launches=counts, ms_per_step=step_ms,
               captured_ms_per_step=captured_ms,
               tokens_per_s=b * t / step_ms * 1e3,
               captured_tokens_per_s=b * t / captured_ms * 1e3)
    line = (f"[rnn] {tag} b{b} x T{t}: {step_ms:.3f} ms/step eager, "
            f"{captured_ms:.3f} captured; {b * t / step_ms * 1e3:.0f} / "
            f"{b * t / captured_ms * 1e3:.0f} tokens/s")
    if name == "lstm_lm":
        res["profile"] = profile_step(lambda: net.prediction(feed), step_ms,
                                      f"rnn {tag} eager")
        res["profile_captured"] = profile_step(lambda: step(feed),
                                               captured_ms,
                                               f"rnn {tag} captured")
        line += (f"; device busy {100 * res['profile']['busy_share_of_step']:.1f}"
                 f"% eager / "
                 f"{100 * res['profile_captured']['busy_share_of_step']:.1f}% "
                 f"captured, {res['profile']['kernel_launches']} / "
                 f"{res['profile_captured']['kernel_launches']} kernel "
                 f"launches a step")
    del step, cap
    log(line + f"; int8 kernels {want} | {card}")
    report.setdefault("rnn", {})[f"{name}_{weights}_b{b}xT{t}"] = res
    return calls


def rnn_cpu_gpu(report):
    """The three nets at full width and RNN_CPU_CUT, card against CPU: the
    float32 net from the tokens, every float edge within RNN_F32_TOL of its
    largest value (LSTM / GRU outputs, the projection, the softmax) and the
    tags equal; its captured forward equal to the eager one; then the bf16
    int8 net (CPU scales) node by node on the CPU's inputs
    (`int8_node_by_node`), and whole from the tokens (reported)."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.graph.ir import topological_order
    from anakin_tpu_torch.quant import calibrate, quantize_graph

    b, t = RNN_CPU_CUT
    res = {}
    for name in RNN_NETS:
        t0 = time.perf_counter()
        feed = rnn_feed(name, b, t, np.random.default_rng(2),
                        lengths=[t, t - 5])
        g = rnn_graph(name, b, t)
        edges = [e for n in topological_order(g) for e in n.outputs]
        net = ak.Net(g, "fp32", tap_edges=edges)
        gpu = net.prediction(feed)
        cpu = ak.Net(g, "fp32", device="cpu", tap_edges=edges).prediction(feed)
        f32 = 0.0
        for e in edges:
            a, c = gpu[e].cpu(), cpu[e]
            if c.is_floating_point():
                f32 = max(f32, float((a - c).abs().max()
                                     / c.abs().max().clamp_min(1e-30)))
            elif not torch.equal(a, c):
                raise AssertionError(f"{name} fp32: {e} differs")
        if f32 > RNN_F32_TOL:
            raise AssertionError(f"{name} fp32: an edge differs by {f32}")
        dev_feed = {k: torch.from_numpy(v).cuda() for k, v in feed.items()}
        eager = net.prediction(dev_feed)
        cap = net.compile(dev_feed)(dev_feed)
        torch.cuda.synchronize()
        if not all(torch.equal(cap[e], eager[e]) for e in g.outputs):
            raise AssertionError(f"{name} fp32: the captured forward differs")
        gq = quantize_graph(g, calibrate(g, [feed], method="max",
                                         device="cpu"))
        qedges = [e for n in topological_order(gq) for e in n.outputs]
        taps = ak.Net(gq, "bf16", device="cpu", tap_edges=qedges).prediction(
            feed)
        taps.update({k: torch.from_numpy(v) for k, v in feed.items()})
        node_rel = int8_node_by_node(gq, taps, f"{name} int8")["float_rel"]
        whole = ak.Net(gq, "bf16").prediction(feed)[gq.outputs[0]].cpu()
        want = taps[gq.outputs[0]]
        whole_diff = (int((whole != want).sum()) if name == "ner_tagger" else
                      float((whole.float() - want.float()).abs().max()))
        res[name] = dict(fp32_edge_max_rel=f32, int8_node_float_max_rel=node_rel,
                         int8_whole=whole_diff)
        log(f"[cpu/gpu rnn] {name} b{b} x T{t} (lengths {t}, {t - 5}): fp32 "
            f"edges max rel diff {f32:.3g} (tol {RNN_F32_TOL}), captured = "
            f"eager; int8 node by node on the CPU's inputs: dense_int8 and "
            f"tags equal, float nodes max rel diff {node_rel:.3g}; whole int8 "
            f"net from the tokens: "
            + (f"{whole_diff} tags differ" if name == "ner_tagger" else
               f"softmax max abs diff {whole_diff:.3g}")
            + f" ({time.perf_counter() - t0:.1f} s)")
    report["rnn_cpu_gpu"] = res


def new_op_cases():
    """(op, inputs, attrs, tolerance) for each of 46 op entries of the
    sequence, tensor and nn modules that no other phase runs, at small
    shapes, with forced ties (crf, topk, pooling), out of range gather and
    one_hot indices and overlapping unpool windows; tolerance "equal" or
    "close" (rtol and atol 1e-5, NaN equal to NaN)."""
    rng = np.random.default_rng(5)

    def n(*s):
        return rng.normal(size=s).astype(np.float32)

    B, T, D, H = 2, 5, 3, 4
    lens = np.array([5, 0], np.int32)
    lstm_w = [n(D, 4 * H), n(H, 4 * H), n(4 * H)]
    ties = np.round(n(1, 6, 6, 2))
    ties[0, :3] = 1.0
    emit = np.round(n(B, T, H))
    emit[0] = 0.0
    trans = np.round(n(H + 2, H))
    trans[2:, 1] = trans[2:, 0]
    topk_x = np.round(n(2, 3, 6))
    topk_x[0, 0] = [2.0, 2.0, 2.0, 1.0, 2.0, 0.0]
    pool = n(1, 4, 4, 2)
    # flat indices as 3 x 3 windows at stride 1 over a 6 x 6 map give them:
    # overlapping windows share a cell, whose values add up
    r, c = np.array([1, 1, 2, 3]), np.array([0, 2, 2, 4])
    pidx = np.repeat((r[:, None] * 6 + c[None, :]).astype(np.int32)[
        None, :, :, None], 2, axis=3)
    return [
        ("lstm", [n(B, T, D)] + lstm_w + [lens],
         dict(has_lengths=True, reverse=True), "close"),
        ("lstmp", [n(B, T, D), n(D, 4 * H), n(2, 4 * H), n(H, 2), n(4 * H),
                   lens], dict(has_lengths=True), "close"),
        ("gru", [n(B, T, D), n(D, 3 * H), n(H, 3 * H), n(3 * H), lens],
         dict(has_lengths=True, reverse=True), "close"),
        ("sequence_concat", [n(B, T, D), n(B, T, H)], {}, "equal"),
        ("seq_concat_seq_pool_soft_sign", [n(B, T, D), n(B, T, H), lens],
         dict(has_lengths=True), "close"),
        ("sequence_expand", [n(B, D), n(B, T, H)], {}, "equal"),
        ("sequence_conv", [n(B, T, D), n(3 * D, H), n(H)],
         dict(has_bias=True), "close"),
        ("sequence_pool_concat", [n(B, T, D), n(B, T, H)], dict(mode="max"),
         "equal"),
        ("reverse_sequence", [n(B, T, D), lens], {}, "equal"),
        ("crf_decoding", [emit, trans, lens], {}, "equal"),
        ("attention_lstm", [n(B, T, D), n(D + H, 6), n(6, 1)] + lstm_w
         + [lens], dict(has_lengths=True), "close"),
        ("attention_padding_mask", [n(B, T, T), lens], {}, "equal"),
        ("permute", [n(2, 3, 4, 5)], dict(order=(0, 3, 1, 2)), "equal"),
        ("transpose", [n(2, 3, 4)], {}, "equal"),
        ("permute_power", [np.abs(n(2, 3, 4))], dict(order=(1, 0, 2),
                                                     power=0.5), "close"),
        ("split", [n(2, 3)], dict(num=2), "equal"),
        ("slice_v2", [n(2, 5, 6)], dict(axes=(1, 2), starts=(-3, 1),
                                        ends=(4, -9)), "equal"),
        ("pad", [n(1, 3, 4, 2)], dict(pad_h=(1, 4), pad_w=(2, 0),
                                      pad_c=(1, 1), mode="reflect"), "equal"),
        ("pixel_shuffle", [n(1, 2, 3, 8)], dict(upscale_factor=2), "equal"),
        ("expand", [n(2, 3)], dict(expand_times=(2, 3)), "equal"),
        ("gather", [n(4, 3), np.array([3, -1, 7, -5, 0], np.int32)],
         dict(axis=0), "equal"),
        ("cast", [n(2, 3) * 9], dict(dtype="int32"), "equal"),
        ("one_hot", [np.array([[0, 5], [-1, 2]], np.int32)], dict(depth=4),
         "equal"),
        ("topk", [topk_x], dict(k=3), "equal"),
        ("reduce", [n(2, 3, 4)], dict(mode="sum", axes=(1,)), "close"),
        ("mean", [n(2, 3)], {}, "close"),
        ("cumsum", [n(2, 4)], dict(axis=1, exclusive=True), "close"),
        ("arithmetic", [n(2, 3), n(2, 3)], dict(mode="sub"), "equal"),
        ("reverse_input", [n(3, 2), n(2, 2)], {}, "equal"),
        ("im2sequence", [n(1, 5, 5, 2)], dict(window=(2, 3), strides=(1, 2),
                                              padding=(1, 0)), "equal"),
        ("coord2patch", [n(2, 4)], {}, "equal"),
        ("pool2d_with_index", [ties], dict(window=(3, 3), strides=(2, 2),
                                           padding=(1, 1)), "equal"),
        ("unpool2d", [pool, pidx], dict(out_hw=(6, 6)), "close"),
        ("spp", [n(1, 7, 5, 2)], dict(mode="avg"), "close"),
        ("matmul", [n(2, 3, 4), n(2, 4, 5)], dict(coeff=0.5), "close"),
        ("group_norm", [n(1, 2, 2, 4), n(4), n(4)], dict(groups=2), "close"),
        ("mvn", [n(1, 3, 3, 2)], {}, "close"),
        ("prelu", [n(1, 2, 2, 3), n(3)], {}, "equal"),
        ("axpy", [n(1, 1, 1, 2), n(1, 2, 2, 2), n(1, 2, 2, 2)], {}, "close"),
        ("power", [np.abs(n(2, 3))], dict(power=0.5, scale=2.0), "close"),
        ("exp", [n(2, 3)], {}, "close"),
        ("log", [np.abs(n(2, 3))], {}, "close"),
        ("erf", [n(2, 3)], {}, "close"),
        ("cos_sim", [n(2, 4), n(2, 4)], {}, "close"),
        ("dot", [n(2, 4), n(2, 4)], {}, "close"),
        ("maxout", [n(1, 2, 2, 4)], dict(groups=2), "equal"),
    ]


def new_ops_on_card(report):
    """Each op entry of `new_op_cases` once on CUDA against the same op on
    the CPU, on the same inputs: the CPU tests' tolerances; unpool2d's
    overlapping windows add on the card in no fixed order, within the
    float32 order of sums."""
    from anakin_tpu_torch.graph.ir import Node
    from anakin_tpu_torch.ops import get_op

    cases = new_op_cases()
    if len({c[0] for c in cases}) != 46:
        raise AssertionError("the op cases do not name 46 entries")
    worst = 0.0
    for op, ins, attrs, tol in cases:
        node = Node("n", op, [f"i{k}" for k in range(len(ins))],
                    ["o0", "o1"], dict(attrs))
        cpu = get_op(op)(node, [torch.from_numpy(a) for a in ins])
        gpu = get_op(op)(node, [torch.from_numpy(a).cuda() for a in ins])
        if len(cpu) != len(gpu):
            raise AssertionError(f"{op}: {len(gpu)} outputs, {len(cpu)} on "
                                 f"the CPU")
        for a, b in zip(gpu, cpu):
            a = a.cpu()
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"{op}: {a.dtype} {tuple(a.shape)} vs "
                                     f"{b.dtype} {tuple(b.shape)}")
            if tol == "equal" or not b.is_floating_point():
                ok = torch.equal(a, b) or (b.is_floating_point() and bool(
                    ((a == b) | (a.isnan() & b.isnan())).all()))
            else:
                ok = torch.allclose(a, b, rtol=1e-5, atol=1e-5, equal_nan=True)
                fin = torch.isfinite(b)
                if fin.any():
                    worst = max(worst, float((a[fin] - b[fin]).abs().max()))
            if not ok:
                raise AssertionError(f"{op}: the card differs from the CPU")
    log(f"[rnn ops] the 46 op entries on the card equal the CPU's (the "
        f"arithmetic ones within rtol / atol 1e-5: max abs diff {worst:.3g})")
    report["new_ops_on_card"] = dict(entries=len(cases), close_max_abs=worst)


def rnn_phase(report, card):
    """Phase 21: the 46 op entries on the card, calibrate the three RNN
    nets on the card, the six runs (bf16 nets, float and int8 weights),
    every distinct int8 kernel shape bit-equal to its plain version, then
    card against CPU.  Returns the int8 runs' kernel calls by run."""
    t0 = time.perf_counter()
    new_ops_on_card(report)
    log(f"[time] phase 21 op entries done at {time.perf_counter() - t0:.0f} s")
    scales = {name: rnn_scales(name) for name in RNN_NETS}
    log(f"[rnn] calibrate on the card: {time.perf_counter() - t0:.1f} s")
    calls = {}
    for name, (b, t) in RNN_NETS.items():
        for weights in ("float", "int8"):
            got = rnn_path(name, weights, scales[name], report, card)
            if got:
                calls[f"{name}_int8_b{b}xT{t}"] = got
    log(f"[time] phase 21 runs done at {time.perf_counter() - t0:.0f} s")
    cnn_kernel_checks(report, calls, key="rnn_kernel_checks", tag="rnn",
                      exact=True)
    rnn_cpu_gpu(report)
    report["rnn_phase_s"] = time.perf_counter() - t0
    log(f"[time] phase 21 took {time.perf_counter() - t0:.0f} s")
    return calls


# ------------------------------------------------------ model IO, converters

IO_BATCH = 32                          # the converted net's run batch
IO_DIR = os.path.join(ROOT, "build", "model_io")
IO_LOGIT_TOL = 1e-4                    # of the largest |logit|
ROUTE_ROUNDS, ROUTE_ITERS = 16, 20     # window pairs, forwards a window


class TorchBottleneck(torch.nn.Module):
    """A ResNet bottleneck of `torch.nn` layers, the stride on the 3x3."""

    def __init__(self, cin, planes, stride, downsample):
        super().__init__()
        nn = torch.nn
        cout = planes * 4
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.relu = nn.ReLU()
        self.down = (nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                   nn.BatchNorm2d(cout))
                     if downsample else None)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + (x if self.down is None else self.down(x)))


class TorchResNet50(torch.nn.Module):
    """ResNet-50 of `torch.nn` layers in the layout of `models/resnet.py`:
    a 7x7 stem, a 3x3 max pool with ceil_mode, [3, 4, 6, 3] bottlenecks,
    GAP and an fc of 1000."""

    def __init__(self):
        super().__init__()
        nn = torch.nn
        self.stem = nn.Sequential(
            nn.Conv2d(3, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64),
            nn.ReLU(), nn.MaxPool2d(3, 2, ceil_mode=True))
        blocks, cin = [], 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                                (3, 4, 6, 3))):
            for i in range(n):
                blocks.append(TorchBottleneck(cin, planes,
                                              2 if stage and not i else 1,
                                              i == 0))
                cin = planes * 4
        self.blocks = nn.Sequential(*blocks)
        self.gap = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(cin, 1000)

    def forward(self, x):
        y = self.blocks(self.stem(x))
        return self.fc(torch.flatten(self.gap(y), 1))


def torch_resnet50():
    """`TorchResNet50` with `torch.manual_seed(0)` init, and BN running
    statistics and affine terms drawn from default_rng(0), so that folding
    them is not the identity."""
    torch.manual_seed(0)
    m = TorchResNet50().eval()
    gen = np.random.default_rng(0)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.num_features
                for t, v in ((mod.running_mean, gen.normal(0, 0.1, c)),
                             (mod.running_var, gen.uniform(0.5, 1.5, c)),
                             (mod.weight, gen.uniform(0.5, 1.0, c)),
                             (mod.bias, gen.normal(0, 0.1, c))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))
    return m


def export_onnx_bytes(module, example):
    """The module through torch's own ONNX exporter (TorchScript, opset
    13), as the JAX package's tests make real ONNX bytes: the machine has
    no `onnx` package, which torch needs only in `_add_onnxscript_fn`, a
    passthrough without custom onnxscript functions, so that one hook is
    replaced; every byte comes from torch's serializer."""
    import io

    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, opsets: model_bytes
    try:
        buf = io.BytesIO()
        torch.onnx.export(module, example, buf, opset_version=13,
                          dynamo=False, do_constant_folding=True)
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig
    return buf.getvalue()


def _same_params(a, b, what):
    if sorted(a) != sorted(b):
        raise AssertionError(f"{what}: param names differ")
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if (x.dtype, x.shape) != (y.dtype, y.shape) or x.tobytes() != y.tobytes():
            raise AssertionError(f"{what}: param {k} differs ({x.dtype} "
                                 f"{x.shape} vs {y.dtype} {y.shape})")


def _outputs_equal(a, b, what):
    for k in a:
        if not torch.equal(a[k], b[k]):
            d = float((a[k].float() - b[k].float()).abs().max())
            raise AssertionError(f"{what}: output {k} differs by {d:g}")


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


CACHE_CHILD = """
import json, sys, time
sys.path.insert(0, {root!r})
from anakin_tpu_torch.kernels import _build
from anakin_tpu_torch.model_io import enable_compilation_cache
enable_compilation_cache(sys.argv[1])
lib, secs, _ = _build.build(sys.argv[2])
_build.load(sys.argv[2])
print(json.dumps({{"lib": lib, "build_s": secs}}))
"""


def compilation_cache_check(report):
    """Two processes with `enable_compilation_cache(<fresh dir>)`: the first
    builds the smallest kernel source (its headers counted) there, the
    second, with no CUDA toolkit it could find (CUDA_HOME pointed at
    nothing), loads the same library and builds nothing."""
    from anakin_tpu_torch.kernels import _build

    def source_bytes(path):  # the file and the headers it includes
        with open(path) as f:
            text = f.read()
        return len(text) + sum(source_bytes(os.path.join(_build.CSRC, h))
                               for h in re.findall(r'#include "(\S+)"', text))

    name = min(_build.SOURCES, key=lambda n: source_bytes(
        os.path.join(_build.CSRC, n + ".cu")))
    cache = os.path.join(IO_DIR, "kernel_cache")
    runs = []
    for env in (dict(os.environ),
                dict(os.environ, CUDA_HOME=os.path.join(IO_DIR, "no_cuda"))):
        proc = subprocess.run(
            [sys.executable, "-c", CACHE_CHILD.format(root=ROOT), cache, name],
            capture_output=True, text=True, env=env, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"cache process failed:\n{proc.stdout}"
                                 f"{proc.stderr}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    log(f"[io] compilation cache, {name}: first process built in "
        f"{runs[0]['build_s']:.1f} s, second (no toolkit) in "
        f"{runs[1]['build_s']:.1f} s, both {os.path.relpath(runs[1]['lib'], ROOT)}")
    if runs[0]["build_s"] <= 0 or runs[1]["build_s"] != 0 \
            or runs[0]["lib"] != runs[1]["lib"]:
        raise AssertionError(f"the second process did not load the cached "
                             f"library: {runs}")
    report["io_compilation_cache"] = dict(source=name, runs=runs)


class _KernelOpCount:
    """Counts the `anakin_tpu_torch::*` registered ops a block of eager
    code dispatches (a dispatch mode, so entered only for a count)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counts = self.counts = {}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.namespace == "anakin_tpu_torch":
                    name = func.overloadpacket.__name__
                    counts[name] = counts.get(name, 0) + 1
                return func(*args, **(kwargs or {}))

        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def op_route_cost(net, feed, out, card, rounds=ROUTE_ROUNDS,
                  iters=ROUTE_ITERS):
    """The host cost of the registered ops on an eager, host-bound b1
    forward: the wrappers as they run eagerly (a direct ctypes launch)
    against every wrapper going through its `torch.library` op, as it does
    under a trace (`torch.compiler.is_compiling` patched to return True).
    Each route is first checked (outputs bit-equal, the same launches, and
    the op route dispatching one op a launch), then `rounds` pairs of
    windows of `iters` forwards each, the pair's order alternating; wall
    clock, synchronized at each window's ends."""
    from unittest import mock

    def via_op():
        return mock.patch.object(torch.compiler, "is_compiling", lambda: True)

    def forward():
        return net.prediction(feed)[out]

    forward()
    torch.cuda.synchronize()
    reset_counts()
    y_direct = forward()
    torch.cuda.synchronize()
    direct_counts = read_counts()
    with via_op(), _KernelOpCount() as ops:
        reset_counts()
        y_op = forward()
        torch.cuda.synchronize()
        op_counts = read_counts()
    _outputs_equal({out: y_direct}, {out: y_op}, "the op route")
    launched = {k: v for k, v in direct_counts.items() if v}
    if op_counts != direct_counts or ops.counts != launched:
        raise AssertionError(f"routes differ: direct {direct_counts}, op "
                             f"{op_counts}, ops dispatched {ops.counts}")

    def window():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            forward()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    def op_window():
        with via_op():
            return window()

    with via_op():
        forward()  # the op route's first call out of the timing
    direct, op = [], []
    for r in range(rounds):
        if r % 2:
            op.append(op_window())
            direct.append(window())
        else:
            direct.append(window())
            op.append(op_window())
    diffs = sorted(o - d for o, d in zip(op, direct))
    n_calls = sum(launched.values())
    res = dict(batch=int(next(iter(feed.values())).shape[0]), rounds=rounds,
               iters=iters, kernel_calls=n_calls,
               direct_ms=statistics.median(direct),
               op_ms=statistics.median(op), direct_windows=direct,
               op_windows=op, diff_ms=statistics.median(diffs),
               diff_q1_ms=diffs[len(diffs) // 4],
               diff_q3_ms=diffs[(3 * len(diffs)) // 4],
               diff_positive=sum(d > 0 for d in diffs))
    res["us_per_call"] = res["diff_ms"] / n_calls * 1e3
    log(f"[io] registered ops' eager cost, b{res['batch']} int8 forward "
        f"({n_calls} kernel calls, {rounds} window pairs of {iters}): direct "
        f"{res['direct_ms']:.3f} ms, through the ops {res['op_ms']:.3f} ms; "
        f"paired difference median {res['diff_ms']:.3f} ms (quartiles "
        f"{res['diff_q1_ms']:.3f} / {res['diff_q3_ms']:.3f}, positive in "
        f"{res['diff_positive']} of {rounds}), {res['us_per_call']:.1f} us a "
        f"call | {card}")
    return res


def model_io_phase(report, card):
    """Phase 22: a ResNet-50 `torch.nn.Module` through `from_torch`,
    `optimize`, `calibrate` on the card and `quantize_graph`, its int8
    kernels at the b32 forward's shapes against their plain versions, the
    registered ops' eager cost at b1, then `save_model` / `load_model`, `export_program` / `load_program`, the
    module through torch's ONNX exporter and `from_onnx`, the converter
    CLI, the kernel build cache and `compare_accuracy`.  Returns the launches of the
    converted int8 net's forward and of the loaded program's call."""
    import shutil

    import anakin_tpu_torch as ak
    from anakin_tpu_torch.kernels.matmul_int8 import prepare_b
    from anakin_tpu_torch.model_io import (export_program, load_model,
                                           load_program, save_model)
    from anakin_tpu_torch.native import native_available
    import yaml

    from anakin_tpu_torch.quant import (calibrate, quantize_graph,
                                        read_scale_table, write_scale_table)
    from anakin_tpu_torch.runtime.net import build_forward
    from anakin_tpu_torch.tools.accuracy import compare_accuracy
    from anakin_tpu_torch.tools.converter import from_onnx, from_torch
    from anakin_tpu_torch.tools.converter.converter import \
        main as converter_main

    t_phase = time.perf_counter()
    shutil.rmtree(IO_DIR, ignore_errors=True)
    os.makedirs(IO_DIR)
    rep = report["model_io"] = {}

    # ------------------------------------------------ convert, float check
    t0 = time.perf_counter()
    module = torch_resnet50()
    g = ak.optimize(from_torch(module, torch.zeros(1, 3, IMAGE, IMAGE)))
    rep["convert_s"] = time.perf_counter() - t0
    inp, out = g.inputs[0], g.outputs[0]
    log(f"[io] from_torch + optimize of the ResNet-50 module (b1, {IMAGE} "
        f"px): {rep['convert_s']:.1f} s, {len(g.nodes)} nodes, passes "
        f"{g.applied_passes}")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(IO_BATCH, 3, IMAGE, IMAGE)).astype(np.float32)).cuda()
    feed = {inp: x.permute(0, 2, 3, 1).contiguous()}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = module.cuda()(x)
        got = ak.Net(g).prediction(feed)[out]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    module.cpu()
    scale = float(want.abs().max())
    gap = float((got - want).abs().max()) / scale
    top1 = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    log(f"[io] float32 net vs the module's forward on the card (TF32 off), "
        f"b{IO_BATCH}: max |logit diff| {gap:.3g} of the largest "
        f"({scale:.4g}), top-1 equal {top1}")
    rep.update(float_gap=gap, largest_logit=scale, top1_equal=top1)
    if not top1 or gap > IO_LOGIT_TOL:
        raise AssertionError(f"converted net differs from the module: gap "
                             f"{gap:g}, top-1 equal {top1}")

    # ----------------------------------------------- quantize, launches
    t0 = time.perf_counter()
    gen = np.random.default_rng(1)
    scales = calibrate(g, [{inp: gen.normal(size=(1, IMAGE, IMAGE, 3))
                            .astype(np.float32)} for _ in range(2)],
                       method="max")
    gq = quantize_graph(g, scales)
    rep["quantize_s"] = time.perf_counter() - t0
    net = ak.Net(gq, precision="bf16")
    net.prediction(feed)
    torch.cuda.synchronize()
    reset_counts()
    prepare_b.calls = 0
    y = net.prediction(feed)
    torch.cuda.synchronize()
    counts_net = read_counts()
    log(f"[io] calibrate (max, 2 b1 batches, on the card) + quantize_graph: "
        f"{rep['quantize_s']:.1f} s; one b{IO_BATCH} int8 forward launches "
        f"{counts_net}, weights prepared in it {prepare_b.calls}")
    if counts_net != dict(no_launches(), matmul_int8=40, conv3x3_int8=13) \
            or prepare_b.calls:
        raise AssertionError(f"expected 40 + 13 launches and no weight "
                             f"prepared, got {counts_net}, {prepare_b.calls}")
    yf = y[out].float()
    if tuple(yf.shape) != (IO_BATCH, 1000) or not torch.isfinite(yf).all():
        raise AssertionError(f"bad int8 output {tuple(yf.shape)}")
    rep["launches"] = counts_net

    # every distinct kernel shape of this b32 forward against its plain
    # version, the shapes tapped from a forward as phase 3 taps them
    edges = [e for n in gq.nodes.values() for e in n.outputs]
    fwd, _ = build_forward(gq, "bf16", tap_edges=edges)
    with torch.inference_mode():
        shapes = {k: tuple(v.shape) for k, v in fwd(net.params, feed).items()}
    calls = kernel_calls(gq, shapes)
    by_kernel = {k: sum(1 for kernel, _ in calls if kernel == k)
                 for k in counts_net}
    if by_kernel != counts_net:
        raise AssertionError(f"the graph's kernel calls {by_kernel} are not "
                             f"the forward's launches {counts_net}")
    cnn_kernel_checks(report, {"converted ResNet-50 int8": calls},
                      key="io_kernel_checks", tag="io", exact=True)
    rep["route"] = op_route_cost(net, {inp: feed[inp][:1].contiguous()}, out,
                                 card)

    # --------------------------------------------------- save and load
    model_dir = os.path.join(IO_DIR, "model")
    t0 = time.perf_counter()
    save_model(gq, model_dir)
    rep["save_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    loaded = load_model(model_dir)
    rep["load_ms"] = (time.perf_counter() - t0) * 1e3
    rep["dir_bytes"] = _dir_bytes(model_dir)
    rep["native_available"] = native_available()
    _same_params(gq.params, loaded.params, "load_model")
    save_model(loaded, os.path.join(IO_DIR, "again"))
    with open(os.path.join(model_dir, "graph.json")) as f1, \
            open(os.path.join(IO_DIR, "again", "graph.json")) as f2:
        if f1.read() != f2.read():
            raise AssertionError("the loaded graph's JSON differs")
    net2 = ak.Net(loaded, precision="bf16")
    y2 = net2.prediction(feed)
    _outputs_equal(y, y2, "the loaded net")
    log(f"[io] save_model {rep['save_ms']:.1f} ms, load_model "
        f"{rep['load_ms']:.1f} ms ({rep['dir_bytes']} bytes; native loader "
        f"{rep['native_available']}): params byte-equal, graph JSON equal, "
        f"outputs bit-equal")

    # -------------------------------------------------- export and load
    prog_path = os.path.join(IO_DIR, "resnet50_int8.pt2")
    t0 = time.perf_counter()
    export_program(net2, feed, prog_path)
    rep["export_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = load_program(prog_path)
    rep["load_program_s"] = time.perf_counter() - t0
    run(feed)
    torch.cuda.synchronize()
    reset_counts()
    y3 = run(feed)
    torch.cuda.synchronize()
    counts_prog = read_counts()
    _outputs_equal(y, y3, "the loaded program")
    if counts_prog != counts_net:
        raise AssertionError(f"the program launched {counts_prog}, the net "
                             f"{counts_net}")
    rep["program_ms"] = cuda_ms(lambda: run(feed), iters=10)
    rep["net_ms"] = cuda_ms(lambda: net2.prediction(feed), iters=10)
    rep["program_bytes"] = os.path.getsize(prog_path)
    log(f"[io] export_program {rep['export_s']:.1f} s ({rep['program_bytes']}"
        f" bytes), load_program {rep['load_program_s']:.1f} s; one call "
        f"launches {counts_prog}, outputs bit-equal; b{IO_BATCH} "
        f"{rep['program_ms']:.3f} ms/step loaded program, {rep['net_ms']:.3f} "
        f"Net | {card}")

    # ------------------------------------------- ONNX and the converter CLI
    t0 = time.perf_counter()
    blob = export_onnx_bytes(module, torch.zeros(1, 3, IMAGE, IMAGE))
    go = ak.optimize(from_onnx(blob))
    y_onnx = ak.Net(go).prediction({go.inputs[0]: feed[inp]})[go.outputs[0]]
    onnx_gap = float((y_onnx - got).abs().max()) / float(got.abs().max())
    onnx_top1 = bool(torch.equal(y_onnx.argmax(-1), got.argmax(-1)))
    rep["onnx"] = dict(seconds=time.perf_counter() - t0, bytes=len(blob),
                       nodes=len(go.nodes), gap=onnx_gap, top1_equal=onnx_top1)
    log(f"[io] torch.onnx.export -> from_onnx -> optimize: {len(blob)} bytes, "
        f"{len(go.nodes)} nodes, {rep['onnx']['seconds']:.1f} s; float32 "
        f"output vs the from_torch graph's, b{IO_BATCH}: {onnx_gap:.3g} of "
        f"the largest, top-1 equal {onnx_top1}")
    if onnx_gap > IO_LOGIT_TOL or not onnx_top1:
        raise AssertionError(f"the ONNX graph differs: {rep['onnx']}")
    t0 = time.perf_counter()
    table = os.path.join(IO_DIR, "scales.txt")
    write_scale_table(scales, table)
    torch.save(module, os.path.join(IO_DIR, "resnet50.pt"))
    config = os.path.join(IO_DIR, "config.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(dict(
            TargetFramework="TORCH", ModelPath=os.path.join(IO_DIR, "resnet50.pt"),
            ExampleInputShape=[1, 3, IMAGE, IMAGE], Optimize=True,
            ScaleTable=table, Output=os.path.join(IO_DIR, "cli")), f)
    if converter_main([config]) != 0:
        raise AssertionError("the converter CLI failed")
    rep["cli_s"] = time.perf_counter() - t0
    save_model(quantize_graph(g, read_scale_table(table)),
               os.path.join(IO_DIR, "cli_reference"))
    for name in ("graph.json", "weights.safetensors"):
        with open(os.path.join(IO_DIR, "cli", name), "rb") as f1, \
                open(os.path.join(IO_DIR, "cli_reference", name), "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"the CLI's {name} differs")
    log(f"[io] converter CLI (TORCH, optimize, scale table) on the saved "
        f"module: {rep['cli_s']:.1f} s, the directory equals save_model of "
        f"the same graph byte for byte")

    # ---------------------------------------- the cache and the harness
    compilation_cache_check(report)
    gen = np.random.default_rng(2)
    acc = compare_accuracy(g, gq, [
        {inp: gen.normal(size=(IO_BATCH, IMAGE, IMAGE, 3)).astype(np.float32)}
        for _ in range(2)])
    log(f"[io] compare_accuracy (float32 nets, two b{IO_BATCH} batches): "
        f"{acc}")
    if acc["samples"] != 2 * IO_BATCH or not all(
            0.0 <= acc[k] <= 1.0 for k in ("top1_agreement", "top5_overlap")):
        raise AssertionError(f"bad accuracy report {acc}")
    rep["accuracy"] = acc
    rep["phase_s"] = time.perf_counter() - t_phase
    log(f"[time] phase 22 took {rep['phase_s']:.0f} s")
    return {"converted ResNet-50 int8": counts_net,
            "exported program": counts_prog}


# ------------------------------------------------------------------ serving

SERVE_NEW = 2 * SCHED_WINDOW   # new tokens of each Generate request
SERVE_POLL_S = 0.05            # how often the service's monitor polls
SERVE_BUCKETS = (1, 2, 4, 8)   # the served CNN's batch sizes
SERVE_DELAY_MS = 10.0          # the in-process batcher's latency window
# requests sent to the in-process batcher at once, each burst answered
# before the next: one burst of 15, then single requests (bucket 1) and
# bursts of 2 and 3
SERVE_BURSTS = (15, 1, 1, 1, 2, 3)
SERVE_BOOT_S = 120             # deadline for a server process to answer
# timed windows, each after a warm-up: (concurrent clients, requests each)
SERVE_LLM_STEADY = (8, 2)      # Generate, once every window graph exists
SERVE_WARM = ((8, 8), (1, 20))  # Evaluate: every bucket's net built, then b1
SERVE_SEQ = (1, 200)           # Evaluate, one request at a time
SERVE_CONC = (8, 32)           # Evaluate, eight clients at once


def _polling_monitor(interval_s):
    """A CUDA `DeviceMonitor` that keeps the time of every sample."""
    from anakin_tpu_torch.serving import DeviceMonitor

    class Monitor(DeviceMonitor):
        def __init__(self):
            self.samples = []
            super().__init__(interval_s=interval_s, device="cuda")

        def _sample(self):
            st = super()._sample()
            self.samples.append(st.sampled_at)
            return st

    return Monitor()


def llm_kernel_shapes(graphs, cfg):
    """The flash_attention ([B, H, Hkv, S, D]) and matmul_w4 ([M, K, N])
    shapes the nodes of `graphs` launch, from shape inference."""
    from anakin_tpu_torch.graph.shape_infer import infer_shapes

    shapes = set()
    for g in graphs:
        sh = infer_shapes(g)
        for n in g.nodes.values():
            if n.op == "dense_w4":
                x, y = sh[n.inputs[0]].shape, sh[n.outputs[0]].shape
                shapes.add(("matmul_w4", (int(np.prod(x[:-1])), x[-1], y[-1])))
            elif n.attrs.get("impl") == "flash":
                b, s, _ = sh[n.inputs[0]].shape
                shapes.add(("flash_attention", (b, cfg.heads, cfg.kv_heads, s,
                                                cfg.head_dim)))
    return shapes


def serve_llm_phase(report, cfg, params, card):
    """Phase 23 a: the Generate RPCs over a DecodeScheduler at phase 15's
    settings (b8, bf16, int8 KV cache, w4, windows of 16, cache views off)
    on a gRPC socket, the service's monitor polling every 50 ms: six
    concurrent clients (Generate and GenerateStream, prompts of
    SCHED_LENGTHS) with the counts set to 0 just before and read just after;
    tokens equal to a direct `submit` of the same requests, each stream's
    frames equal to its final tokens, NOT_FOUND for an unknown model, the
    windows captured graphs while the monitor polled, and every flash and
    matmul_w4 shape the scheduler's graphs launch one that phase 7 holds to
    its plain version.  Then a timed window of SERVE_LLM_STEADY requests,
    once every window graph and bucket net exists (none may be made in it).
    Returns the serving run's launches."""
    from concurrent.futures import ThreadPoolExecutor

    import grpc
    from anakin_tpu_torch.runtime import DecodeScheduler
    from anakin_tpu_torch.runtime.graphs import CapturedStep
    from anakin_tpu_torch.serving import AnakinService, RpcClient, serve

    t_phase = time.perf_counter()
    rep = report["serve_llm"] = {}
    t0 = time.perf_counter()
    sched = DecodeScheduler(cfg, batch=LLM_BATCH, params=params,
                            precision="bf16", kv_cache_dtype="int8",
                            weight_only="w4", cache_view="off",
                            fuse_window=SCHED_WINDOW, device="cuda")
    rep["scheduler_build_s"] = time.perf_counter() - t0
    monitor = _polling_monitor(SERVE_POLL_S)
    svc = AnakinService(monitor=monitor.start())
    svc.initial_llm("llm1b", sched)
    server = serve(svc, port=0)
    target = f"127.0.0.1:{server._bound_port}"
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, (L,)).astype(np.int32)
               for L in SCHED_LENGTHS]

    def call(i):
        client = RpcClient(target)
        try:
            if i % 2 == 0:
                return [client.generate("llm1b", prompts[i], SERVE_NEW,
                                        request_id=i)]
            return list(client.generate_stream("llm1b", prompts[i], SERVE_NEW,
                                               request_id=i))
        finally:
            client.close()

    try:
        reset_counts()
        n0 = len(monitor.samples)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(prompts)) as pool:
            answers = [f.result(timeout=600) for f in
                       [pool.submit(call, i) for i in range(len(prompts))]]
        rpc_s = time.perf_counter() - t0
        counts = read_counts()
        polls = monitor.samples[n0:]
        status = monitor.status()
        t0 = time.perf_counter()
        direct = [f.result(timeout=600) for f in
                  [sched.submit(p, SERVE_NEW) for p in prompts]]
        direct_s = time.perf_counter() - t0
        client = RpcClient(target)
        try:
            missing = []
            for fn in (lambda: client.generate("nope", [1, 2]),
                       lambda: list(client.generate_stream("nope", [1, 2]))):
                try:
                    fn()
                    missing.append("no error")
                except grpc.RpcError as e:
                    missing.append(e.code().name)
        finally:
            client.close()
        windows = list(sched._fused_runs.values())
        graphs = [sched.graph, *sched._prefill_graphs.values()]
        buckets = sorted(sched._prefill_graphs)
        # a steady window: new prompts of the same lengths, once every
        # window graph and bucket net exists
        clients, each = SERVE_LLM_STEADY
        steady_prompts = [
            rng.integers(0, cfg.vocab, (SCHED_LENGTHS[i % len(SCHED_LENGTHS)],)
                         ).astype(np.int32) for i in range(clients * each)]

        def steady_client(c):
            client, rows = RpcClient(target), []
            try:
                for i in range(c * each, (c + 1) * each):
                    t1 = time.perf_counter()
                    if i % 2 == 0:
                        frames = [client.generate("llm1b", steady_prompts[i],
                                                  SERVE_NEW, request_id=i)]
                        first_ms = None
                    else:
                        frames = []
                        for f in client.generate_stream(
                                "llm1b", steady_prompts[i], SERVE_NEW,
                                request_id=i):
                            if not frames:
                                first_ms = (time.perf_counter() - t1) * 1e3
                            frames.append(f)
                    rows.append(dict(
                        rtt_ms=(time.perf_counter() - t1) * 1e3,
                        service_ms=frames[-1]["info"]["duration_ms"],
                        first_frame_ms=first_ms,
                        new=len(frames[-1]["tokens"]) - len(steady_prompts[i])))
            finally:
                client.close()
            return rows

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=clients) as pool:
            steady = [r for f in [pool.submit(steady_client, c)
                                  for c in range(clients)]
                      for r in f.result(timeout=600)]
        steady_s = time.perf_counter() - t0
        made_in_window = (len(sched._fused_runs) - len(windows),
                          sorted(set(sched._prefill_graphs) - set(buckets)))
    finally:
        server.stop(0).wait(10)
        svc.shutdown()  # closes the scheduler and stops the monitor

    tokens = []
    for i, frames in enumerate(answers):
        final = frames[-1]
        if i % 2 and (not final.get("done") or [f["token"] for f in frames[:-1]]
                      != final["tokens"][len(prompts[i]):]):
            raise AssertionError(f"request {i}: the stream's frames are not "
                                 f"its final tokens")
        if final["request_id"] != i:
            raise AssertionError(f"request {i} answered as {final['request_id']}")
        tokens.append(final["tokens"])
    equal = all(t == [int(v) for v in d] for t, d in zip(tokens, direct))
    gaps = np.diff(polls)
    service_ms = [a[-1]["info"]["duration_ms"] for a in answers]
    n_tok = sum(len(t) - len(p) for t, p in zip(tokens, prompts))
    log(f"[serve llm] scheduler (b{LLM_BATCH}, bf16, int8 KV, w4, windows of "
        f"{SCHED_WINDOW}) built in {rep['scheduler_build_s']:.1f} s; "
        f"{len(prompts)} concurrent clients (Generate / GenerateStream, "
        f"prompts {list(SCHED_LENGTHS)}, {SERVE_NEW} new tokens; the "
        f"warm-up: the first window capture and bucket nets) answered in "
        f"{rpc_s:.2f} s, {n_tok / rpc_s:.1f} tokens/s; the service's ms per "
        f"request {[round(d, 1) for d in service_ms]}; the same requests "
        f"submitted directly {direct_s:.2f} s; tokens equal {equal}; unknown "
        f"model {missing}; launches while serving {counts} | {card}")
    log(f"[serve llm] the monitor polled {len(polls)} times while serving "
        f"(every {SERVE_POLL_S * 1e3:.0f} ms asked, largest gap "
        f"{gaps.max() * 1e3 if gaps.size else float('nan'):.1f} ms), last "
        f"{status.to_dict()}; {len(windows)} window graphs captured, buckets "
        f"admitted {buckets}")
    if not equal:
        raise AssertionError("the RPC tokens differ from direct submission")
    if missing != ["NOT_FOUND"] * 2:
        raise AssertionError(f"an unknown model gave {missing}")
    if not windows or not all(isinstance(r, CapturedStep) for r in windows):
        raise AssertionError("the windows were not captured graphs")
    if len(polls) < rpc_s / SERVE_POLL_S / 4 or not gaps.size \
            or gaps.max() > 20 * SERVE_POLL_S:
        raise AssertionError(f"the monitor did not poll while serving: "
                             f"{len(polls)} samples in {rpc_s:.1f} s")
    if status.device != torch.cuda.get_device_name(0) \
            or status.bytes_in_use <= 0 or status.platform != "gpu":
        raise AssertionError(f"bad device status {status}")
    if counts != dict(no_launches(), flash_attention=counts["flash_attention"],
                      matmul_w4=counts["matmul_w4"],
                      matmul_w4_wgmma=counts["matmul_w4_wgmma"]) \
            or not counts["flash_attention"] or not counts["matmul_w4"] \
            or not counts["matmul_w4_wgmma"]:
        raise AssertionError(f"expected flash_attention and matmul_w4 "
                             f"launches only, some on the wgmma route, got "
                             f"{counts}")
    held = set()
    for r in report["llm_kernel_configs"]:
        if r["dtype"] == "bfloat16" and r["kernel"] in (
                "flash_attention", "matmul_w4", "matmul_w4_wgmma"):
            flash = r["kernel"] == "flash_attention"
            held.add(("flash_attention" if flash else "matmul_w4",
                      tuple(r["shape"][:5 if flash else 3])))
    launched = llm_kernel_shapes(graphs, cfg)
    unheld = sorted(launched - held)
    log(f"[serve llm] {len(launched)} distinct flash / matmul_w4 shapes in the "
        f"scheduler's graphs, none outside phase 7: {not unheld}")
    if unheld:
        raise AssertionError(f"shapes phase 7 does not check: {unheld}")
    steady_tok = sum(r["new"] for r in steady)
    st_ms = [r["service_ms"] for r in steady]
    first = [r["first_frame_ms"] for r in steady if r["first_frame_ms"]]
    log(f"[serve llm] steady window after the warm-up: {len(steady)} requests "
        f"({clients} clients x {each}, prompts of {list(SCHED_LENGTHS)} in "
        f"turn, {SERVE_NEW} new tokens) in {steady_s:.3f} s, {steady_tok} "
        f"tokens, {steady_tok / steady_s:.1f} tokens/s; the service's ms a "
        f"request median {statistics.median(st_ms):.1f} (min {min(st_ms):.1f}, "
        f"max {max(st_ms):.1f}); a stream's first frame median "
        f"{statistics.median(first):.1f} ms over {len(first)}; window graphs "
        f"and bucket nets made in the window {made_in_window} | {card}")
    if made_in_window != (0, []) or steady_tok != len(steady) * SERVE_NEW:
        raise AssertionError(f"the steady window was not steady: made "
                             f"{made_in_window}, {steady_tok} tokens")
    rep.update(rpc_s=rpc_s, tokens=n_tok, tokens_per_s=n_tok / rpc_s,
               steady_s=steady_s, steady_tokens=steady_tok,
               steady_tokens_per_s=steady_tok / steady_s, steady=steady,
               service_ms=service_ms, direct_s=direct_s, launches=counts,
               polls=len(polls), largest_poll_gap_s=float(gaps.max()),
               windows_captured=len(windows), buckets=buckets,
               shapes=sorted([k, list(s)] for k, s in launched))
    rep["phase_s"] = time.perf_counter() - t_phase
    log(f"[time] phase 23 a took {rep['phase_s']:.0f} s | {card}")
    return counts


def serve_cnn_phase(report, card):
    """Phase 23 b: the int8 ResNet-50 directory phase 22 saved, served.  In
    process, a ContinuousBatcher over the server's own factory (buckets 1,
    2, 4, 8, bf16) with the counts set to 0 just before and read just
    after: each result bit-equal to a fresh `Net` of its bucket on the same
    zero-padded batch, 40 matmul_int8 + 13 conv3x3_int8 a batch; every
    distinct int8 shape of the four buckets bit-equal to its plain version;
    a Worker over the b1 net (3 threads, sync and async in FIFO order).
    Then a ServingDaemon over a server process on the card: ListModels, a
    warm-up, then timed windows of Evaluate requests one at a time (each
    bit-equal to the b1 net's) and from eight clients at once, each
    request's round trip beside the server's `duration_ms`; the device
    status, the child terminated and restarted, Evaluate again; the b1 and
    b8 forwards in this process, boot and restart seconds, and the arena
    plan beside the allocator's peak for the b8 net.  Returns the launches
    of one served batch, from the counts."""
    import socket
    from concurrent.futures import ThreadPoolExecutor

    from anakin_tpu_torch.convert import to_numpy
    from anakin_tpu_torch.graph.passes.memory import plan_memory
    from anakin_tpu_torch.model_io import load_model
    from anakin_tpu_torch.runtime import Net, Worker
    from anakin_tpu_torch.serving import ContinuousBatcher, RpcClient
    from anakin_tpu_torch.serving.daemon import ServerSpec, ServingDaemon
    from anakin_tpu_torch.serving.server import make_net_factory, with_batch

    t_phase = time.perf_counter()
    rep = report["serve_cnn"] = {}
    model_dir = os.path.join(IO_DIR, "model")
    graph = load_model(model_dir)
    inp, out = graph.inputs[0], graph.outputs[0]
    gen = np.random.default_rng(8)
    images = [gen.normal(size=(IMAGE, IMAGE, 3)).astype(np.float32)
              for _ in range(sum(SERVE_BURSTS))]

    # ------------------------------------------------ in process: batcher
    batcher = ContinuousBatcher(make_net_factory(graph, "bf16", "cuda"),
                                [inp], buckets=SERVE_BUCKETS,
                                max_delay_ms=SERVE_DELAY_MS)
    try:
        reset_counts()
        outs, i = [], 0
        t0 = time.perf_counter()
        for n in SERVE_BURSTS:
            outs += [f.result(timeout=300) for f in
                     [batcher.submit({inp: x}) for x in images[i:i + n]]]
            i += n
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = read_counts()
        sizes = batcher.batch_sizes_served()
    finally:
        batcher.shutdown()
    nb = len(sizes)
    log(f"[serve cnn] in-process batcher (buckets {list(SERVE_BUCKETS)}, "
        f"bf16, {SERVE_DELAY_MS} ms window): {sum(SERVE_BURSTS)} requests in "
        f"bursts {list(SERVE_BURSTS)}, {serve_s:.2f} s with the nets' build, "
        f"batches {sizes}; launches {counts}")
    if counts != dict(no_launches(), matmul_int8=40 * nb, conv3x3_int8=13 * nb):
        raise AssertionError(f"expected 40 + 13 launches a batch for {nb} "
                             f"batches, got {counts}")
    if max(sizes) < 2:
        raise AssertionError(f"no batch of two or more: {sizes}")
    fresh, i = {}, 0
    for n in sizes:
        bucket = next(b for b in SERVE_BUCKETS if b >= n)
        net = fresh.setdefault(bucket, Net(with_batch(graph, bucket),
                                           precision="bf16"))
        batch = np.stack(images[i:i + n] + [np.zeros_like(images[0])] *
                         (bucket - n))
        want = to_numpy(net.prediction({inp: batch})[out])
        for j in range(n):
            if outs[i + j][out].tobytes() != want[j].tobytes():
                raise AssertionError(f"request {i + j} differs from a fresh "
                                     f"b{bucket} net")
        i += n
    log(f"[serve cnn] every result bit-equal to a fresh Net of its bucket on "
        f"the same zero-padded batch ({out}: {outs[0][out].dtype})")
    calls = {f"b{b}": cnn_calls(with_batch(graph, b)) for b in SERVE_BUCKETS}
    for name, cs in calls.items():
        if sum(k == "matmul_int8" for k, _ in cs) != 40 or \
                sum(k == "conv3x3_int8" for k, _ in cs) != 13:
            raise AssertionError(f"{name}: the graph's kernel calls are not "
                                 f"40 + 13")
    cnn_kernel_checks(report, calls, key="serve_kernel_checks", tag="serve",
                      exact=True)

    # --------------------------------------------------------- Worker, b1
    net1 = fresh[1]
    w = Worker(net1, num_threads=3)
    try:
        feeds = [{inp: x[None]} for x in images[:6]]
        sync = [f.result(timeout=120) for f in
                [w.sync_prediction(f) for f in feeds]]
        for f in feeds:
            w.async_prediction(f)
        fifo = [w.async_get_result(timeout=120) for _ in feeds]
        lat = w.prediction_times_ms()
    finally:
        w.shutdown()
    w = Worker(net1, num_threads=1)  # the same requests, one at a time
    try:
        alone = [w.sync_prediction(f).result(timeout=120) for f in feeds]
        lat1 = w.prediction_times_ms()
    finally:
        w.shutdown()
    for f, a, b, c in zip(feeds, sync, fifo, alone):
        want = to_numpy(net1.prediction(f)[out]).tobytes()
        if a[out].tobytes() != want or b[out].tobytes() != want \
                or c[out].tobytes() != want:
            raise AssertionError("a Worker's result differs from "
                                 "net.prediction")
    log(f"[serve cnn] Worker over the b1 net, 3 threads: 6 sync and 6 async "
        f"results equal to net.prediction, the async ones in FIFO order; "
        f"median latency {statistics.median(lat):.2f} ms (wall), against "
        f"{statistics.median(lat1):.2f} ms for the same requests one at a "
        f"time on one thread")

    # ----------------------------------------- a server under the daemon
    # each image's answer at b1, which a request served alone must equal
    ref1 = [to_numpy(net1.prediction({inp: x[None]})[out])[0] for x in images]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    target, name = f"127.0.0.1:{port}", "resnet50_int8"
    daemon = ServingDaemon([ServerSpec(
        model_dir=model_dir, name=name, port=port,
        extra_args=["--buckets", ",".join(map(str, SERVE_BUCKETS)),
                    "--device", "cuda"])])

    def evaluate_when_up(k):
        client = RpcClient(target)
        try:
            client.wait_ready(timeout=SERVE_BOOT_S)
            return client.evaluate(name, {inp: images[k]}, request_id=k)
        finally:
            client.close()

    def window(clients, each):
        """`clients` RpcClients at once, each sending `each` Evaluate
        requests one after another (request i: image i mod the images);
        returns the wall seconds and, a request each, its round trip, the
        server's `duration_ms` and the response."""
        def run(c):
            client, rows = RpcClient(target), []
            try:
                for i in range(c * each, (c + 1) * each):
                    t1 = time.perf_counter()
                    r = client.evaluate(name, {inp: images[i % len(images)]},
                                        request_id=i)
                    rows.append(((time.perf_counter() - t1) * 1e3,
                                 r["info"]["duration_ms"], r))
            finally:
                client.close()
            return rows

        t1 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=clients) as pool:
            rows = [r for f in [pool.submit(run, c) for c in range(clients)]
                    for r in f.result(timeout=300)]
        return time.perf_counter() - t1, rows

    def stats(wall, rows):
        rtt = np.array([r[0] for r in rows])
        srv = np.array([r[1] for r in rows])
        return dict(requests=len(rows), wall_s=wall,
                    requests_per_s=len(rows) / wall,
                    rtt_ms={q: float(np.percentile(rtt, q)) for q in (50, 90, 99)},
                    server_ms={q: float(np.percentile(srv, q))
                               for q in (50, 90, 99)},
                    outside_server_share=float(np.median((rtt - srv) / rtt)))

    t0 = time.perf_counter()
    daemon.start()
    try:
        first = evaluate_when_up(0)
        boot_s = time.perf_counter() - t0
        client = RpcClient(target)
        try:
            models = client.list_models()
        finally:
            client.close()
        for w_ in SERVE_WARM:
            window(*w_)
        seq = window(*SERVE_SEQ)
        conc = window(*SERVE_CONC)
        status = conc[1][-1][2]["info"]["device_status"]
        # the server's monitor samples every 5 s (the service's default):
        # ask until a sample taken after its first net
        client, t1 = RpcClient(target), time.perf_counter()
        try:
            while status["bytes_in_use"] <= 0 and time.perf_counter() - t1 < 15:
                time.sleep(0.5)
                status = client.evaluate(name, {inp: images[0]})[
                    "info"]["device_status"]
        finally:
            client.close()
        child = daemon._procs[0]
        t1 = time.perf_counter()
        child.terminate()
        child.wait(timeout=30)
        deadline = time.monotonic() + 60
        while not (daemon.restarts()[0] == 1 and daemon.alive()[0]
                   and daemon._procs[0] is not child):
            if time.monotonic() > deadline:
                raise AssertionError("the daemon did not restart its child "
                                     "within 60 s")
            time.sleep(0.05)
        respawn_s = time.perf_counter() - t1
        after = evaluate_when_up(1)
        restart_s = time.perf_counter() - t1
    finally:
        daemon.stop()
    for r in [first, *(row[2] for row in seq[1]), after]:
        k = r["request_id"] % len(images)
        if r["outputs"][out].tobytes() != ref1[k].tobytes():
            raise AssertionError(f"the server's answer for image {k}, served "
                                 f"alone, differs from the b1 net's")
    conc_diff = max(float(np.abs(row[2]["outputs"][out].astype(np.float32) -
                                 ref1[row[2]["request_id"] % len(images)]
                                 .astype(np.float32)).max())
                    for row in conc[1])
    if not all(row[2]["outputs"][out].shape == ref1[0].shape and
               np.isfinite(row[2]["outputs"][out]).all() for row in conc[1]):
        raise AssertionError("a concurrent answer is not finite or has the "
                             "wrong shape")
    st = status
    if models != [name] or st["device"] != torch.cuda.get_device_name(0) \
            or st["platform"] != "gpu" or st["bytes_in_use"] <= 0 \
            or after["info"]["device_status"]["device"] != st["device"]:
        raise AssertionError(f"bad ListModels {models} or status {st}")
    if any(daemon.alive().values()):
        raise AssertionError("a server process outlived daemon.stop()")
    seq_st, conc_st = stats(*seq), stats(*conc)

    # ------------------------------------------------------------ timings
    net8 = fresh[8] if 8 in fresh else Net(with_batch(graph, 8),
                                           precision="bf16")
    feed1 = {inp: images[0][None]}
    feed8 = {inp: np.stack(images[:8])}
    b1_ms = cuda_ms(lambda: net1.prediction(feed1), iters=5)
    b8_ms = cuda_ms(lambda: net8.prediction(feed8), iters=5)
    torch.cuda.synchronize()
    resting = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    net8.prediction(feed8)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    plan = plan_memory(with_batch(graph, 8))

    def fmt(d):
        return (f"{d['requests']} requests in {d['wall_s']:.3f} s, "
                f"{d['requests_per_s']:.1f} requests/s; round trip p50 / p90 "
                f"/ p99 {d['rtt_ms'][50]:.2f} / {d['rtt_ms'][90]:.2f} / "
                f"{d['rtt_ms'][99]:.2f} ms; in the server (duration_ms: "
                f"window, batch, forward, copy back) {d['server_ms'][50]:.2f} / "
                f"{d['server_ms'][90]:.2f} / {d['server_ms'][99]:.2f} ms; "
                f"outside the server (client, msgpack, gRPC) median "
                f"{100 * d['outside_server_share']:.1f}% of a round trip")

    log(f"[serve cnn] daemon: server up and answering in {boot_s:.1f} s "
        f"(one sample); ListModels {models}; device status {st}; after a "
        f"warm-up of {SERVE_WARM} (clients, requests each) | {card}")
    log(f"[serve cnn] Evaluate, one client, one request at a time: "
        f"{fmt(seq_st)}; every answer bit-equal to the b1 net's | {card}")
    log(f"[serve cnn] Evaluate, {SERVE_CONC[0]} clients at once: "
        f"{fmt(conc_st)}; answers finite, largest difference from the b1 "
        f"net's {conc_diff:.3g} (a batch of another size) | {card}")
    log(f"[serve cnn] child terminated, restarted after {respawn_s:.1f} s, "
        f"answering again {restart_s:.1f} s after the kill (one sample) | "
        f"{card}")
    log(f"[serve cnn] in this process, not the server's (CUDA events): b1 "
        f"forward {b1_ms:.3f} ms, b8 {b8_ms:.3f} ms; b8 plan_memory: "
        f"{plan.summary()}; allocator peak of a b8 forward "
        f"{(peak - resting) / 1e6:.2f} MB above the resting "
        f"{resting / 1e6:.2f} MB | {card}")
    rep.update(batches=sizes, launches=counts, serve_s=serve_s,
               worker_latency_ms=lat, worker_one_thread_ms=lat1, boot_s=boot_s, respawn_s=respawn_s,
               restart_s=restart_s, sequential=seq_st, concurrent=conc_st,
               sequential_rows=[r[:2] for r in seq[1]],
               concurrent_rows=[r[:2] for r in conc[1]],
               concurrent_max_diff=conc_diff,
               b1_forward_ms=b1_ms, b8_forward_ms=b8_ms,
               plan=dict(summary=plan.summary(), arena_bytes=plan.arena_bytes,
                         naive_bytes=plan.naive_bytes),
               peak_above_resting_bytes=peak - resting, resting_bytes=resting,
               device_status=st)
    rep["phase_s"] = time.perf_counter() - t_phase
    log(f"[time] phase 23 b took {rep['phase_s']:.0f} s | {card}")
    return {k: v // nb for k, v in counts.items() if v}


# ---------------------------------------------------------- parallelism

# phase 24: two gloo ranks share the one card (NCCL refuses two ranks on
# one device), so its times say nothing about scaling
GLOO_LABEL = "gloo on one card: no scaling evidence"
TP_RANKS = 2
TP_RESNET_BATCH = 8
# the TP scheduler's requests: prompts of buckets 64 (two), 640 and 1024
# (flash), 16 new tokens each, b8 slots: the 1,000-token one parted from
# the unsharded scheduler at a bf16 tie in an earlier run, so a parting is
# held to the two top choices
TP_SCHED_LENGTHS, TP_SCHED_NEW = (40, 600, 1000, 50), 16
RING_SHAPE = dict(B=2, H=8, S=4096, D=128)
PHASE24_DIR = os.path.join(ROOT, "build", "phase24")
# gloo hands a CUDA tensor's device pointer to its socket on send / recv,
# and the process aborts ("writev ... Bad address"; H100 runs of this
# phase), so under gloo on CUDA that kind is staged without a probe
GLOO_CUDA_ABORTS = ("send_recv",)


def _tp_mesh(rank, port):
    """Rank `rank` of the 2-rank gloo group on cuda:0 and its (1, 2) mesh;
    the kinds gloo refuses on CUDA (probed, and GLOO_CUDA_ABORTS) staged
    through pinned host memory."""
    import torch.distributed as dist
    from anakin_tpu_torch.parallel import initialize, make_mesh
    from anakin_tpu_torch.parallel.mesh import (COLLECTIVE_KINDS,
                                                probe_cuda_collectives)

    torch.cuda.set_device(0)
    initialize(f"localhost:{port}", num_processes=TP_RANKS, process_id=rank,
               backend="gloo")
    mesh = make_mesh(model=TP_RANKS)
    taken = probe_cuda_collectives(mesh, "cuda", kinds=[
        k for k in COLLECTIVE_KINDS if k not in GLOO_CUDA_ABORTS])
    mesh.stage([k for k, ok in taken.items() if not ok] + list(GLOO_CUDA_ABORTS))
    return mesh, {"backend": dist.get_backend(),
                  "cards": torch.cuda.device_count(), "taken": taken,
                  "staged": sorted(mesh.staged)}


class launched_llm_shapes:
    """Inside the block, the flash_attention and matmul_w4 launches are
    recorded (`.seen`) as the arguments check_flash and check_w4 take,
    read from the launches' own operands, over every entry of the block;
    `.w4_calls` counts the matmul_w4 launches of each."""

    def __init__(self):
        self.seen = set()
        self.w4_calls = collections.Counter()

    def __enter__(self):
        import importlib

        # the modules (the package's names are the wrappers)
        fa, mw = (importlib.import_module(f"anakin_tpu_torch.kernels.{m}")
                  for m in ("flash_attention", "matmul_w4"))
        self._mods = fa, mw
        self._runs = fa._flash_attention, mw._matmul_w4
        run_fa, run_w4 = self._runs

        def flash(q, k, v, q_segs, kv_segs, *, causal, sm_scale):
            if q.is_cuda:
                lens = None if q_segs is None else tuple(
                    (q_segs == 0).sum(1).tolist())
                B, H, S, D = q.shape
                self.seen.add(("flash_attention", (
                    B, H, k.shape[1], S, D, str(q.dtype), bool(causal), lens,
                    abs(sm_scale * D ** 0.5 - 1.0) < 1e-12,
                    q_segs is kv_segs)))
            return run_fa(q, k, v, q_segs, kv_segs, causal=causal,
                          sm_scale=sm_scale)

        def w4(x, packed, scales, *, group, variant):
            if x.is_cuda:
                key = (x.shape[0], x.shape[1], packed.shape[1], group,
                       str(x.dtype), scales.dtype == torch.bfloat16, variant)
                self.seen.add(("matmul_w4", key))
                self.w4_calls[key] += 1
            return run_w4(x, packed, scales, group=group, variant=variant)

        fa._flash_attention, mw._matmul_w4 = flash, w4
        return self

    def __exit__(self, *exc):
        fa, mw = self._mods
        fa._flash_attention, mw._matmul_w4 = self._runs


def check_launched_llm_shapes(shapes):
    """Each recorded flash_attention / matmul_w4 launch (launched_llm_shapes)
    against its plain version at phase 7's tolerances, untimed; a launch
    whose arguments check_flash cannot rebuild (another softmax scale, q
    and kv segments apart) fails."""
    dts = {"torch.bfloat16": torch.bfloat16, "torch.float32": torch.float32}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    rows = []
    for kernel, key in sorted(shapes, key=str):
        if kernel == "flash_attention":
            B, H, Hkv, S, D, dt, causal, lens, std_scale, same_segs = key
            if not (std_scale and same_segs):
                raise AssertionError(f"a flash launch the check cannot "
                                     f"rebuild: {key}")
            r = check_flash(B, H, Hkv, S, D, dts[dt], causal,
                            None if lens is None else list(lens), gen, 0,
                            timed=False)
        else:
            M, K, N, G, dt, bf16_scales, variant = key
            r = check_w4(M, K, N, G, dts[dt], gen, 0, variant=variant,
                         bf16_scales=bf16_scales, timed=False)
        r["variant"] = key[-1] if kernel == "matmul_w4" else None
        rows.append(r)
        log(f"[tp] {kernel} at a TP launch {list(key)}: err "
            f"{r['max_abs_err']:.3g} ok={r['ok']}")
    return rows


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def save_llm_params(params) -> None:
    """The 1B-class weights, one .npy an array, for phase 24's ranks."""
    pdir = os.path.join(PHASE24_DIR, "llm_params")
    os.makedirs(pdir, exist_ok=True)
    for k, v in params.items():
        np.save(os.path.join(pdir, k + ".npy"), v)


def _wall_ms(fn, n=3):
    """Median host milliseconds of `fn()` ended by a synchronize."""
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def tp_resnet(mesh, rank, report):
    """24 b: ResNet-50 int8 (224 px, b8, the checked-in scales) at tp 2: the
    rank's softmax and every int8 node's output equal to the unsharded
    Net's on the card (int8 edges and softmax bit for bit); the launches of
    one forward; rank 0 holds every distinct shard shape of matmul_int8 and
    conv3x3_int8 to its plain version, bit for bit."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.graph.shape_infer import infer_shapes
    from anakin_tpu_torch.parallel import shard_graph_params

    gq = build_graph(TP_RESNET_BATCH)
    x = np.random.default_rng(0).normal(
        size=(TP_RESNET_BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    edges = [n.outputs[0] for n in gq.nodes.values()
             if n.op in ("conv2d_int8", "dense_int8")]
    out_e = gq.outputs[0]
    ref = ak.Net(gq, precision="bf16", device="cuda", tap_edges=edges)
    want = ref.prediction({"input": x})
    net = ak.Net(gq, precision="bf16", device="cuda", mesh=mesh,
                 param_sharding=shard_graph_params(gq, mesh), tap_edges=edges)
    net.prediction({"input": x})  # warm-up
    reset_counts()
    mesh.take_records()
    got = net.prediction({"input": x})
    torch.cuda.synchronize()
    counts = read_counts()
    records = mesh.take_records()
    differ = [e for e in edges + [out_e] if not torch.equal(got[e], want[e])]
    kinds = {}
    for k in net.forward.kinds.values():
        kinds[k] = kinds.get(k, 0) + 1
    res = dict(launches=counts, int8_nodes=len(edges), differ=differ,
               kinds=kinds, softmax_equal=out_e not in differ,
               tp_ms=_wall_ms(lambda: net.prediction({"input": x})),
               unsharded_ms=_wall_ms(lambda: ref.prediction({"input": x})),
               collectives=len(records),
               collective_bytes=sum(r["result_bytes"] for r in records))
    if rank == 0:
        calls = kernel_calls(gq, {k: tuple(v.shape) for k, v in
                                  infer_shapes(gq).items()}, local=net.params)
        rows = cnn_kernel_checks(report, {"tp2": calls},
                                 key="tp_resnet_kernel_checks", tag="tp2",
                                 exact=True)
        res["shard_shapes"] = len(rows)
    return res


def _llm_params(d):
    """The 1B-class weights the parent wrote (memory-mapped)."""
    pdir = os.path.join(d, "llm_params")
    return {f[:-4]: np.load(os.path.join(pdir, f), mmap_mode="r")
            for f in sorted(os.listdir(pdir))}


def _first_parting(a, b):
    n = min(len(a), len(b))
    diff = np.nonzero(np.asarray(a[:n]) != np.asarray(b[:n]))[0]
    return int(diff[0]) if len(diff) else (None if len(a) == len(b) else n)


def _top2(cfg, params, packed, seq, upto):
    """(the top-2 logit margin as a share of the largest |logit|, the two
    top tokens) of the unsharded bf16 w4 net on seq[:upto] (one b1 prefill
    at its bucket: the logits that chose token `upto`)."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.models import build_transformer_prefill
    from anakin_tpu_torch.quant import weight_only_quantize
    from anakin_tpu_torch.runtime.generate import prefill_bucket

    L = prefill_bucket(upto, cfg.max_seq)
    g = weight_only_quantize(build_transformer_prefill(
        cfg, 1, L, params, kv_cache_dtype="int8", last_token_only=True),
        bits=4, packed=packed)
    ids = np.zeros((1, L), np.int32)
    ids[0, :upto] = seq[:upto]
    row = ak.Net(g, precision="bf16", device="cuda").prediction(
        {"input": ids, "nreal": np.array([upto], np.int32)})[
        g.outputs[0]].float().reshape(-1)
    top = torch.topk(row, 2)
    return (float((top.values[0] - top.values[1]) / row.abs().max()),
            top.indices.tolist())


# the step checks of 24 c: (precision, layers (None: all 16), tolerance as a
# share of the largest logit).  float32 at full depth holds the sharded
# arithmetic (the two sum in other orders: ~1e-5 on the CPU at 16
# layers); bf16 at the depth of phase 8's card-vs-CPU check holds LLM_TOL;
# bf16 at full depth, the path itself (None), is held to the bf16
# rounding of the unsharded step at the same depth on the same inputs:
# gap = |unsharded bf16 - unsharded float32|, and the TP bf16 step must be
# within TP_BF16_GAP[0] x gap of the unsharded bf16 step (the two are each
# a bf16 rounding away from the float32 step) and within TP_BF16_GAP[1] x
# gap of the float32 step (no less accurate than the unsharded bf16 step,
# to half again)
TP_STEP_CHECKS = (("fp32", None, 1e-3), ("bf16", 2, LLM_TOL),
                  ("bf16", None, None))
TP_BF16_GAP = (2.0, 1.5)


def tp_llm(mesh, rank, d, report):
    """24 c: the 1B-class w4 decode step (int8 KV cache, b8, distinct
    positions) at tp 2 against the unsharded step (rank 0), as
    TP_STEP_CHECKS says; then the TP scheduler (b8, w4, int8 KV, windows of
    16, views off) serving TP_SCHED_LENGTHS, against the unsharded
    scheduler's tokens (rank 0): equal, or parting only where the two
    tokens are the unsharded net's top two and their margin is under
    LLM_TOL (a near-tie; printed).  Every flash / matmul_w4 launch of the
    TP runs is recorded (`res["launched"]`)."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.models import (TransformerConfig,
                                         build_transformer_decode_step)
    from anakin_tpu_torch.parallel import MODEL_AXIS, shard_graph_params
    from anakin_tpu_torch.parallel.mesh import Spec
    from anakin_tpu_torch.parallel.tensor_parallel import local_block
    from anakin_tpu_torch.quant import weight_only_quantize
    from anakin_tpu_torch.runtime import DecodeScheduler

    cfg = TransformerConfig(**LLM_CFG)
    params = _llm_params(d)
    packed = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    shape = (LLM_BATCH, cfg.kv_heads, cfg.max_seq, cfg.head_dim)
    caches = {f"cache_{kv}_{i}": torch.randint(
        -127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        for i in range(cfg.layers) for kv in "kv"}
    tok = torch.randint(0, cfg.vocab, (LLM_BATCH, 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    pos = torch.tensor(np.minimum(np.arange(LLM_BATCH) * 287 + 40,
                                  cfg.max_seq - 1), dtype=torch.int32,
                       device="cuda")
    res = {"steps": []}
    t_steps = time.perf_counter()
    tap = launched_llm_shapes()
    unsharded = {}  # (precision, layers) -> the unsharded step's logits
    for prec, layers, tol in TP_STEP_CHECKS:
        layers = layers or cfg.layers
        cfg_l = TransformerConfig(**dict(LLM_CFG, layers=layers))
        t0 = time.perf_counter()
        g = weight_only_quantize(build_transformer_decode_step(
            cfg_l, LLM_BATCH, params, kv_cache_dtype="int8",
            cache_update="rows"), bits=4, packed=packed)
        cache_out = [e for n in g.nodes.values() if n.op == "mha_decode"
                     for e in n.outputs[1:]]
        specs = {k: Spec(None, MODEL_AXIS, None, None)
                 if k.startswith("cache_") else Spec() for k in g.inputs}
        net = ak.Net(g, precision=prec, device="cuda", mesh=mesh,
                     param_sharding=shard_graph_params(g, mesh),
                     input_shardings=specs, local_outputs=cache_out)
        full = {k: caches[k] for k in g.inputs if k.startswith("cache_")}
        row = dict(precision=prec, layers=layers, tolerance=tol,
                   build_s=time.perf_counter() - t0)

        def tp_step():
            feed = {k: local_block(v, specs[k], mesh).clone()
                    for k, v in full.items()}
            with torch.inference_mode():
                return net.forward(net.params, dict(feed, input=tok, pos=pos),
                                   net.prepared)[g.outputs[0]]

        with tap:
            tp_step()  # warm-up
        reset_counts()
        logits = tp_step()
        torch.cuda.synchronize()
        row.update(launches=read_counts(), ms=_wall_ms(tp_step))
        if (prec, layers) == ("bf16", cfg.layers):  # the path's own step
            res.update(step_launches=row["launches"], step_ms=row["ms"],
                       kinds={k: sum(v == k for v in net.forward.kinds.values())
                              for k in set(net.forward.kinds.values())})
        del net
        if rank == 0:
            ref = ak.Net(g, precision=prec, device="cuda")

            def ref_step():
                with torch.inference_mode():
                    return ref.prediction(dict(
                        {k: v.clone() for k, v in full.items()}, input=tok,
                        pos=pos))[g.outputs[0]]

            want = unsharded[prec, layers] = ref_step().float()
            row["rel_err"] = float((logits.float() - want).abs().max()
                                   / want.abs().max())
            row["unsharded_ms"] = _wall_ms(ref_step)
            del ref
            if tol is None:  # bf16 at full depth: against the bf16 rounding
                f32 = unsharded["fp32", layers]
                mag = f32.abs().max()
                gap = float((want - f32).abs().max() / mag)
                row.update(
                    bf16_gap=gap,
                    tp_to_fp32=float((logits.float() - f32).abs().max() / mag),
                    tolerance=TP_BF16_GAP[0] * gap,
                    tolerance_to_fp32=TP_BF16_GAP[1] * gap)
        res["steps"].append(row)
    del caches, unsharded
    res["steps_s"] = time.perf_counter() - t_steps

    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in TP_SCHED_LENGTHS]
    kw = dict(batch=LLM_BATCH, params=params, precision="bf16",
              kv_cache_dtype="int8", weight_only="w4", cache_view="off",
              fuse_window=SCHED_WINDOW, device="cuda")
    t0 = time.perf_counter()
    sched = DecodeScheduler(cfg, mesh=mesh, **kw)
    res["sched_build_s"] = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    with tap:
        try:
            if rank == 0:
                toks = [f.result(timeout=900) for f in
                        [sched.submit(p, max_new_tokens=TP_SCHED_NEW)
                         for p in prompts]]
                res["sched_s"] = time.perf_counter() - t0
        finally:
            sched.close(timeout=900)  # every rank's loop ends on rank 0's stop
    torch.cuda.synchronize()
    res.update(sched_launches=read_counts(),
               sched_windows=sched.fused_windows_run,
               sched_bucket_prefills=sched.bucket_prefills_run,
               sched_disagreements=sched.token_disagreements,
               launched=sorted(tap.seen, key=str))
    del sched
    if rank == 0:
        t0 = time.perf_counter()
        base = DecodeScheduler(cfg, **kw)
        try:
            want = [f.result(timeout=900) for f in
                    [base.submit(p, max_new_tokens=TP_SCHED_NEW)
                     for p in prompts]]
        finally:
            base.close()
        del base
        res["ref_sched_s"] = time.perf_counter() - t0
        partings = []
        for p, a, b in zip(prompts, toks, want):
            i = _first_parting(a, b)
            if i is not None:
                margin, top2 = _top2(cfg, params, packed, b, i)
                partings.append(dict(
                    prompt=len(p), step=i - len(p), margin=margin, top2=top2,
                    tp_token=int(a[i]) if i < len(a) else None,
                    unsharded_token=int(b[i]) if i < len(b) else None))
        res["partings"] = partings
        res["tokens_equal"] = not partings
    return res


def tp_rings(mesh, rank):
    """24 e: ring attention over the two ranks' sequence blocks against
    plain float32 attention on one rank (rank 0), causal and not; the two
    overlap rings against the dense product."""
    from anakin_tpu_torch.ops.nn import full_fp32
    from anakin_tpu_torch.parallel import ring_attention
    from anakin_tpu_torch.parallel.overlap import (allgather_matmul,
                                                   matmul_reducescatter)

    B, H, S, D = (RING_SHAPE[k] for k in "BHSD")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    q, k, v = (torch.randn((B, H, S, D), generator=gen, device="cuda")
               for _ in range(3))
    i, s = mesh.axis_index("model"), S // TP_RANKS
    blk = [t[:, :, i * s:(i + 1) * s].contiguous() for t in (q, k, v)]
    res = {}
    for causal in (False, True):
        got = ring_attention(*blk, mesh, "model", causal=causal)
        whole = mesh.all_gather(got, "model", 2)
        res[f"ring_ms_causal_{causal}"] = _wall_ms(
            lambda: ring_attention(*blk, mesh, "model", causal=causal))
        if rank == 0:
            with full_fp32():
                sc = torch.einsum("bhqd,bhkd->bhqk", q, k) / D ** 0.5
                if causal:
                    t = torch.arange(S, device="cuda")
                    sc = torch.where(t[None, :] <= t[:, None], sc, -torch.inf)
                want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(sc, -1), v)
            res[f"ring_err_causal_{causal}"] = float((whole - want).abs().max())
            del sc, want
    M, K, N = 4096, 2048, 4096
    x = torch.randn((M, K), generator=gen, device="cuda")
    w = torch.randn((K, N), generator=gen, device="cuda")
    m, kk = M // TP_RANKS, K // TP_RANKS
    with full_fp32():
        dense = x @ w
    ag = allgather_matmul(x[i * m:(i + 1) * m], w, "model", mesh=mesh)
    rs = matmul_reducescatter(x[:, i * kk:(i + 1) * kk].contiguous(),
                              w[i * kk:(i + 1) * kk], "model", mesh=mesh)
    mag = float(dense.abs().max())
    res["allgather_rel_err"] = float((ag - dense).abs().max()) / mag
    res["reducescatter_rel_err"] = float(
        (rs - dense[i * m:(i + 1) * m]).abs().max()) / mag
    res["allgather_ms"] = _wall_ms(lambda: allgather_matmul(
        x[i * m:(i + 1) * m], w, "model", mesh=mesh))
    with full_fp32():
        res["dense_ms"] = _wall_ms(lambda: x @ w)
    return res


def tp_rank_main(rank, port, d) -> int:
    """One rank of phase 24 (a, b, c, e): results to `d/rank<r>.json`.
    Rank 0 also holds every flash / matmul_w4 launch of both ranks' TP
    runs to its plain version."""
    import torch.distributed as dist

    report = {}
    mesh, probe = _tp_mesh(rank, port)
    out = {"rank": rank, "probe": probe}
    t0 = time.perf_counter()
    out["resnet"] = tp_resnet(mesh, rank, report)
    out["resnet_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["llm"] = tp_llm(mesh, rank, d, report)
    out["llm_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["rings"] = tp_rings(mesh, rank)
    out["rings_s"] = time.perf_counter() - t0
    out["kernel_checks"] = report.get("tp_resnet_kernel_checks")
    launched = [None] * TP_RANKS
    dist.all_gather_object(launched, out["llm"]["launched"])
    if rank == 0:
        t0 = time.perf_counter()
        shapes = {k for keys in launched for k in keys}
        out["llm_kernel_checks"] = check_launched_llm_shapes(shapes)
        out["llm_checked"] = sorted(shapes, key=str)
        out["llm_checks_s"] = time.perf_counter() - t0
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def tp_pipeline(report):
    """24 d: `PipelinedNet` of ResNet-50 int8 (b128, bf16) in 4 stages on
    cuda:0, 2 and 4 microbatches: output equal to the Net's on each
    microbatch, bit for bit; launches of the 4-microbatch run."""
    import anakin_tpu_torch as ak
    from anakin_tpu_torch.parallel import PipelinedNet, split_graph

    gq = build_graph(BATCH)
    x = np.random.default_rng(0).normal(size=(BATCH, IMAGE, IMAGE, 3)).astype(
        np.float32)
    out_e = gq.outputs[0]
    net = ak.Net(gq, precision="bf16", device="cuda")
    pnet = PipelinedNet(gq, ["cuda"] * 4, precision="bf16")
    res = {"stages": [len(g.nodes) for g in split_graph(gq, 4)]}
    for m in (2, 4):
        mb = BATCH // m
        want = torch.cat([net.prediction({"input": x[j * mb:(j + 1) * mb]})[
            out_e] for j in range(m)])
        pnet.prediction({"input": x}, microbatches=m)  # warm-up
        if m == 4:
            reset_counts()
        got = pnet.prediction({"input": x}, microbatches=m)[out_e]
        torch.cuda.synchronize()
        if m == 4:
            res["launches"] = read_counts()
        res[f"equal_m{m}"] = bool(torch.equal(got, want))
        res[f"ms_m{m}"] = _wall_ms(lambda: pnet.prediction(
            {"input": x}, microbatches=m))
    res["net_ms"] = _wall_ms(lambda: net.prediction({"input": x}))
    res["equal_b128_net"] = bool(torch.equal(
        got, net.prediction({"input": x})[out_e]))
    report["tp_pipeline"] = res
    return res


def parallel_phase(report, card):
    """Phase 24: a, b, c and e in two rank processes (this script with
    `--tp-rank`, on the weights `save_llm_params` wrote) sharing cuda:0
    over gloo, then d here.  Any rank that fails fails the phase.  Returns
    {path: launches} for the kernels line."""
    t_start = time.perf_counter()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
         "--tp-port", str(port)], cwd=ROOT) for r in range(TP_RANKS)]
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise AssertionError(f"phase 24: a rank failed (exit codes {rcs})")
    ranks = []
    for r in range(TP_RANKS):
        with open(os.path.join(PHASE24_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    pipe = tp_pipeline(report)
    report["tp_ranks"] = ranks
    r0 = ranks[0]
    pr = r0["probe"]
    log(f"[tp] {pr['cards']} card(s), backend {pr['backend']}: CUDA tensors "
        f"taken for " + (", ".join(k for k, ok in pr["taken"].items() if ok)
                         or "none")
        + f" (probed); not probed, since gloo aborts the process on them: "
        f"{', '.join(GLOO_CUDA_ABORTS)}; staged through pinned host memory: "
        + (", ".join(pr["staged"]) or "none"))
    for r in ranks:
        rn, ll, rg = r["resnet"], r["llm"], r["rings"]
        log(f"[tp] rank {r['rank']} ResNet-50 int8 b{TP_RESNET_BATCH} tp2: "
            f"{rn['int8_nodes']} int8 nodes + softmax, differing from the "
            f"unsharded Net: {rn['differ'] or 'none'}; nodes by kind "
            f"{rn['kinds']}; launches matmul_int8 "
            f"{rn['launches']['matmul_int8']}, conv3x3_int8 "
            f"{rn['launches']['conv3x3_int8']}; {rn['tp_ms']:.1f} ms a "
            f"forward against {rn['unsharded_ms']:.1f} ms unsharded "
            f"({GLOO_LABEL}); {rn['collectives']} collectives a forward, "
            f"{rn['collective_bytes'] / 1e6:.1f} MB of results")
        log(f"[tp] rank {r['rank']} w4 decode step tp2 (bf16, all layers): "
            f"matmul_w4 {ll['step_launches']['matmul_w4']} launches, "
            f"{ll['step_ms']:.1f} ms ({GLOO_LABEL}); scheduler built in "
            f"{ll['sched_build_s']:.1f} s: flash {ll['sched_launches']['flash_attention']}, "
            f"matmul_w4 {ll['sched_launches']['matmul_w4']} launches, "
            f"{ll['sched_windows']} windows, {ll['sched_bucket_prefills']} "
            f"bucket admissions, {ll['sched_disagreements']} token "
            f"disagreements")
        log(f"[tp] rank {r['rank']} rings: {rg} ({GLOO_LABEL}); seconds: "
            f"resnet {r['resnet_s']:.1f}, llm {r['llm_s']:.1f}, rings "
            f"{r['rings_s']:.1f}")
    ll = r0["llm"]
    for st in ll["steps"]:
        log(f"[tp] w4 step {st['precision']}, {st['layers']} layers, against "
            f"the unsharded step: {st['rel_err']:.2e} of the largest logit "
            f"(tolerance {st['tolerance']:.3g}"
            + ("" if "bf16_gap" not in st else
               f" = {TP_BF16_GAP[0]} x the unsharded bf16 step's gap to its "
               f"float32 step, {st['bf16_gap']:.2e}; the TP bf16 step to the "
               f"float32 step {st['tp_to_fp32']:.2e}, tolerance "
               f"{st['tolerance_to_fp32']:.3g}") + f"); "
            f"{st['ms']:.1f} ms TP, {st['unsharded_ms']:.1f} ms unsharded "
            f"({GLOO_LABEL}), built in {st['build_s']:.1f} s")
    log(f"[tp] scheduler partings {ll['partings'] or 'none'} "
        f"({len(TP_SCHED_LENGTHS)} requests x {TP_SCHED_NEW} tokens in "
        f"{ll['sched_s']:.1f} s)")
    log(f"[tp] rank 0's LLM part: the step checks {ll['steps_s']:.1f} s, "
        f"the TP scheduler built in {ll['sched_build_s']:.1f} s and run in "
        f"{ll['sched_s']:.1f} s, the unsharded scheduler built and run in "
        f"{ll['ref_sched_s']:.1f} s")
    checks = r0["llm_kernel_checks"]
    log(f"[tp] {len(checks)} distinct flash / matmul_w4 launches of the TP "
        f"runs (both ranks) held to their plain versions in "
        f"{r0['llm_checks_s']:.1f} s: "
        f"{sum(r['ok'] for r in checks)} ok")
    log(f"[tp] pipeline ResNet-50 int8 b{BATCH}, 4 stages of "
        f"{pipe['stages']} nodes: m=2 {pipe['ms_m2']:.1f} ms, m=4 "
        f"{pipe['ms_m4']:.1f} ms against the Net's {pipe['net_ms']:.1f} ms, "
        f"wall, the input's copy included (the stages share one card: no "
        f"scaling evidence); equal to the Net per microbatch: "
        f"{pipe['equal_m2']}, {pipe['equal_m4']}; to the b{BATCH} forward: "
        f"{pipe['equal_b128_net']}")
    bad = []
    for r in ranks:
        rn, ll, rg = r["resnet"], r["llm"], r["rings"]
        if rn["differ"]:
            bad.append(f"rank {r['rank']}: TP ResNet outputs differ {rn['differ'][:4]}")
        if rn["launches"]["matmul_int8"] != 40 or rn["launches"]["conv3x3_int8"] != 13:
            bad.append(f"rank {r['rank']}: TP ResNet launches {rn['launches']}")
        if ll["step_launches"]["matmul_w4"] == 0:
            bad.append(f"rank {r['rank']}: no matmul_w4 launch in the TP step")
        for st in ll["steps"]:
            if st["precision"] == "fp32" and not (
                    0 < st["launches"]["matmul_w4"]
                    == st["launches"]["matmul_w4_f32"]):
                bad.append(f"rank {r['rank']}: the float32 TP step's matmul_w4 "
                           f"launches off the float32 routes: {st['launches']}")
        if (ll["sched_launches"]["flash_attention"] == 0
                or ll["sched_launches"]["matmul_w4"] == 0):
            bad.append(f"rank {r['rank']}: TP scheduler launches "
                       f"{ll['sched_launches']}")
        if ll["sched_windows"] == 0 or ll["sched_bucket_prefills"] == 0:
            bad.append(f"rank {r['rank']}: TP scheduler ran no window or admission")
        if ll["sched_disagreements"]:
            bad.append(f"rank {r['rank']}: {ll['sched_disagreements']} token "
                       f"disagreements between the ranks")
        unchecked = ({str(k) for k in ll["launched"]}
                     - {str(k) for k in r0["llm_checked"]})
        kinds = {k[0] for k in ll["launched"]}
        if unchecked or kinds != {"flash_attention", "matmul_w4"}:
            bad.append(f"rank {r['rank']}: TP launches unchecked {unchecked}, "
                       f"kernels recorded {kinds}")
    if r0["resnet"].get("shard_shapes", 0) == 0:
        bad.append("no shard shape checked")
    bad += [f"{r['kernel']} {r['shape']} {r['dtype']} differs from its plain "
            f"version at a TP launch (err {r['max_abs_err']})"
            for r in r0["llm_kernel_checks"] if not r["ok"]]
    ll = r0["llm"]
    for st in ll["steps"]:
        if not st["rel_err"] <= st["tolerance"]:
            bad.append(f"TP w4 step ({st['precision']}, {st['layers']} "
                       f"layers): logits {st['rel_err']} of the largest")
        if "bf16_gap" in st and not st["tp_to_fp32"] <= st["tolerance_to_fp32"]:
            bad.append(f"TP w4 step (bf16, {st['layers']} layers): "
                       f"{st['tp_to_fp32']} from the float32 step, against "
                       f"the unsharded bf16 step's {st['bf16_gap']}")
    for p in ll["partings"]:
        if p["margin"] >= LLM_TOL or set(p["top2"]) != {
                p["tp_token"], p["unsharded_token"]}:
            bad.append(f"TP scheduler tokens part other than at a near-tie "
                       f"of the two top choices: {p}")
    rg = r0["rings"]
    for c in (False, True):
        if not rg[f"ring_err_causal_{c}"] <= 1e-4:
            bad.append(f"ring attention (causal {c}) differs by "
                       f"{rg[f'ring_err_causal_{c}']}")
    for r in ranks:
        for key in ("allgather_rel_err", "reducescatter_rel_err"):
            if not r["rings"][key] <= 1e-5:
                bad.append(f"rank {r['rank']} {key} {r['rings'][key]}")
    if not (pipe["equal_m2"] and pipe["equal_m4"]):
        bad.append("PipelinedNet differs from the Net")
    if pipe["launches"]["matmul_int8"] != 160 or pipe["launches"]["conv3x3_int8"] != 52:
        bad.append(f"pipeline launches {pipe['launches']}")
    if bad:
        raise AssertionError("phase 24: " + "; ".join(bad))
    secs = time.perf_counter() - t_start
    report["phase24_s"] = secs
    log(f"[tp] phase 24 in {secs:.1f} s | {card}")
    paths = {}
    for r in ranks:
        paths[f"tp2 ResNet-50 int8 b{TP_RESNET_BATCH} forward, rank {r['rank']}"] = \
            r["resnet"]["launches"]
        paths[f"tp2 w4 decode step, rank {r['rank']}"] = r["llm"]["step_launches"]
        for st in r["llm"]["steps"]:
            if st["precision"] == "fp32":
                paths[f"tp2 float32 w4 decode step ({st['layers']} layers), "
                      f"rank {r['rank']}"] = st["launches"]
        paths[f"tp2 scheduler ({len(TP_SCHED_LENGTHS)} requests), rank "
              f"{r['rank']}"] = r["llm"]["sched_launches"]
    paths[f"pipeline ResNet-50 int8 b{BATCH}, 4 stages x 4 microbatches"] = \
        pipe["launches"]
    return paths


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1, 7 and 13 and phases 18, 19 and 21's "
                         "kernel checks only: build, then flash_attention "
                         "and matmul_w4 v1/v2 against their plain versions, "
                         "and the int8 kernels at every distinct shape of the "
                         "CNN, detection and RNN paths (no main path, so no "
                         "result line)")
    ap.add_argument("--phase24-only", action="store_true",
                    help="phases 1 and 24 alone: the build, then the "
                         "parallel phase (the quick loop for parallel work; "
                         "no result line)")
    ap.add_argument("--w4-only", action="store_true",
                    help="phase 1, then phase 7's timed matmul_w4 rows at "
                         "phase 15's bucket admissions and phase 15's "
                         "admission ms per bucket (the quick loop for the "
                         "M > 16 route; no result line)")
    ap.add_argument("--tp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)  # a phase 24 rank process
    ap.add_argument("--tp-port", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on a GPU")
        return 1
    if args.tp_rank is not None:
        return tp_rank_main(args.tp_rank, args.tp_port, PHASE24_DIR)
    from anakin_tpu_torch.kernels import _build
    from anakin_tpu_torch.models import TransformerConfig, make_transformer_params

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
            if "registers" in line or "spill" in line or "Compiling" in line \
                    or "C75" in line:  # ptxas's wgmma serialization notes
                log(f"[build]   {line.strip()}")
    check_ptxas(built["flash_attention"][2], "flash_wgmma")
    # the instructions the depthwise and fused-block kernels spend, counted
    # in their SASS
    for name in ("depthwise3x3_int8", "bottleneck_int8"):
        report["sass_" + name] = log_sass(built[name][0], name)

    if args.phase24_only:
        t0 = time.perf_counter()
        save_llm_params(make_transformer_params(TransformerConfig(**LLM_CFG), 0))
        log(f"[tp] 1B-class weights made and written in "
            f"{time.perf_counter() - t0:.1f} s")
        paths = parallel_phase(report, card)
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        with open(os.path.join(ROOT, "build", "chip_smoke_phase24.json"),
                  "w") as f:
            json.dump(dict(report, paths=paths), f, indent=1, default=str)
        log(f"[time] phase 24 alone done at {time.perf_counter() - t_start:.0f} s")
        return 0

    if args.w4_only:
        w4_admission_only(report, card)
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        with open(os.path.join(ROOT, "build", "chip_smoke_w4.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        log(f"[time] w4 rows and admissions done at "
            f"{time.perf_counter() - t_start:.0f} s")
        return 0

    if args.kernels_only:
        cfg = TransformerConfig(**LLM_CFG)
        llm_kernels(report, cfg)
        w4_v2_kernels(report, cfg)
        cnn_kernel_checks(report, {
            f"{name}_int8": cnn_calls(cnn_graph(name, batch,
                                                scales=cnn_scales(name)))
            for name, precision, batch in CNN_RUNS if precision == "int8"})
        cnn_kernel_checks(report, {
            name: cnn_calls(det_graph(name, size, det_scales(name, size)))
            for name, size in DET_NETS.items()}, key="det_kernel_checks",
            tag="det", exact=True)
        cnn_kernel_checks(report, {
            name: cnn_calls(rnn_graph(name, *RNN_NETS[name],
                                      scales=rnn_scales(name)))
            for name in RNN_NETS}, key="rnn_kernel_checks", tag="rnn",
            exact=True)
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        with open(os.path.join(ROOT, "build", "chip_smoke_kernels.json"), "w") as f:
            json.dump(report, f, indent=1)
        log(f"[time] kernel phases done at {time.perf_counter() - t_start:.0f} s")
        return 0

    # ------------------------------------------------------- 2-4. ResNet
    results, counts, resnet = resnet_phases(report, card)
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
    f32_prefill_counts = float32_session_prefill(report, cfg, params, card)
    counts["matmul_w4"] = llm_path_b(report, cfg, params, card)["matmul_w4"]
    f32_step_counts, f32_calls = llm_path_b_f32(report, cfg, params, card)
    counts["matmul_w4_f32"] = f32_step_counts["matmul_w4_f32"]
    units.update(flash_attention="one generate (its 512-token prefill)",
                 matmul_w4=f"{NEW} w4 decode steps",
                 matmul_w4_f32="one float32 w4 decode step (phase 6 b)")
    results += llm_kernels(report, cfg)
    attach_w4_calls(results, f32_calls, "matmul_w4_f32", "phase 6 b")
    llm_cpu_gpu(report, cfg)
    log(f"[time] LLM phases done at {time.perf_counter() - t_start:.0f} s")

    # ----------------------------------------------------- 9-11. MobileNet
    dw_results, counts["depthwise3x3_int8"] = mobilenet_phases(report, card)
    results += dw_results
    units["depthwise3x3_int8"] = "one MobileNet v1 and one v2 forward"
    log(f"[time] MobileNet phases done at {time.perf_counter() - t_start:.0f} s")

    # -------------------------------------------------- 12-13. w4 v2 ladder
    counts["matmul_w4_v2"] = llm_path_b_v2(report, cfg, params, card)[
        "matmul_w4_v2"]
    units["matmul_w4_v2"] = f"{NEW} distinct-position w4 decode steps"
    results += w4_v2_kernels(report, cfg)
    W4_PACKED.clear()
    log(f"[time] w4 v2 phases done at {time.perf_counter() - t_start:.0f} s")

    # ------------------------------------------------------ 14. bottleneck
    bn_results, counts["bottleneck_int8"] = bottleneck_phase(report, card,
                                                             resnet)
    del resnet
    results += bn_results
    units["bottleneck_int8"] = ("the 12 identity blocks of one ResNet-50 b128 "
                                "forward")
    log(f"[time] bottleneck phase done at {time.perf_counter() - t_start:.0f} s")

    # ------------------------------------------------------- 15. scheduler
    report["scheduler_launches"], wgmma_calls = scheduler_phase(
        report, cfg, params, card)
    counts["matmul_w4_wgmma"] = report["scheduler_launches"]["matmul_w4_wgmma"]
    units["matmul_w4_wgmma"] = ("phase 15's counted round (its bucket "
                                "admissions' MLP projections)")
    attach_w4_calls(results, wgmma_calls, "matmul_w4_wgmma", "phase 15")
    log(f"[time] scheduler phase done at {time.perf_counter() - t_start:.0f} s")

    # ----------------------------------------------------- 16. speculative
    f32_spec_counts = speculative_phase(report, cfg, params, card)
    log(f"[time] speculative phase done at "
        f"{time.perf_counter() - t_start:.0f} s")

    # ------------------------------------------- 23 a. the Generate RPCs
    serve_llm_counts = serve_llm_phase(report, cfg, params, card)
    save_llm_params(params)  # for phase 24's rank processes
    del params
    torch.cuda.empty_cache()
    log(f"[time] serving phase (LLM) done at "
        f"{time.perf_counter() - t_start:.0f} s")

    # ------------------------------------------- 17. tuned long-context prefill
    counts["flash_attention_f32"] = tuned_prefill_phase(report, card)[
        "flash_attention_f32"]
    units["flash_attention_f32"] = (
        "one tuning of phase 17's attention key (the flash candidate: "
        "float32 [2, 8, 8, 2048, 128] causal)")
    attach_tuner_calls(results, counts["flash_attention_f32"])
    log(f"[time] tuned prefill phase done at "
        f"{time.perf_counter() - t_start:.0f} s")

    # ----------------------------------------------------- 18. CNN breadth
    results += cnn_phases(report, card)
    log(f"[time] CNN phase done at {time.perf_counter() - t_start:.0f} s")

    # ------------------------------------------- 19-20. detection, segmentation
    det_calls = det_phase(report, card)
    seg_phase(report, card)
    log(f"[time] detection and segmentation phases done at "
        f"{time.perf_counter() - t_start:.0f} s")

    # ------------------------------------------------------------ 21. RNNs
    rnn_calls = rnn_phase(report, card)
    log(f"[time] RNN phase done at {time.perf_counter() - t_start:.0f} s")

    # ------------------------------------------ 22. model IO and converters
    io_counts = model_io_phase(report, card)
    log(f"[time] model IO phase done at {time.perf_counter() - t_start:.0f} s")

    # --------------------------------------- 23 b. the served int8 ResNet-50
    io_counts["served ResNet-50 int8 (one batch)"] = dict(
        no_launches(), **serve_cnn_phase(report, card))
    io_counts["Generate RPCs (6 requests)"] = serve_llm_counts
    io_counts["float32 session prefill (phase 5 b)"] = f32_prefill_counts
    io_counts["draft = target float32 generate (phase 16)"] = f32_spec_counts
    log(f"[time] serving phase (CNN) done at "
        f"{time.perf_counter() - t_start:.0f} s")

    # ----------------------------------------------------- 24. parallelism
    for path, counts_tp in parallel_phase(report, card).items():
        io_counts[path] = dict(no_launches(), **counts_tp)
    log(f"[time] all phases done at {time.perf_counter() - t_start:.0f} s")

    kernels = summarize(results, counts, units)
    paths = dict({f"{net}_b1": calls for net, calls in det_calls.items()},
                 **rnn_calls)
    for k in kernels:  # later paths' int8 runs, each counted in its run
        k["launches_by_path"] = {
            path: sum(1 for kernel, _ in calls if kernel == k["name"])
            for path, calls in paths.items()}
        for path, counts_io in io_counts.items():
            k["launches_by_path"][path] = counts_io[k["name"]]
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
    sys.exit(main(sys.argv[1:]))
