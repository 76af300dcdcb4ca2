"""A whole run on the CPU at small sizes (the harness's look for a card
skipped): sound, `correct` comes out true; with the timed path broken
underneath, an answer or a token altered where it is produced, false."""

import numpy as np
import pytest

from portbench import harness
from portbench.tests import tiny


def _run(name, trace=False, control=False):
    return harness.run_cell(name, 2 ** 31 + 12345, 10.0 if trace else 3.0,
                            trace, device="cpu",
                            cell=tiny.cell(name, control=control),
                            log=lambda *a: None, control=control)


@pytest.mark.parametrize("name", [tiny.A, tiny.B, tiny.C])
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", [tiny.A, tiny.B, tiny.C])
def test_control_is_not_correct(name):
    """The lower-precision control in the program's place (int4 weights for
    the CNN, float8 activations for the decoder), judged by the cell's own
    limits, comes out not correct; the program on the same run does."""
    out = _run(name, control=True)
    assert out["correct"] is True, out["checks"]
    assert out["control"]["correct"] is False, out["control"]
    assert set(out["control"]["checks"]) == set(out["checks"])


def test_sample_covers_every_request_sent_at_the_open():
    from types import SimpleNamespace

    from portbench import loads
    from portbench.models.decoder_w4 import Runner

    reqs = []
    for i in range(40):
        r = loads.Request(i, np.zeros(5, np.int32), 0, at_open=i < 16)
        r.tokens = np.arange(100 + (i * 37) % 300, dtype=np.int32)
        r.times = [0.0, 1.0]
        reqs.append(r)
    run = Runner.__new__(Runner)
    run.ctx = SimpleNamespace(seed=2 ** 31 + 5)
    run.traffic = dict(check_requests=24, check_prefix=64)
    run.sent, run.owes_all, run.t_close = reqs, False, 2.0
    picked = run.sample()
    longest = max(reqs, key=lambda r: len(r.tokens))
    assert picked[0] == (longest, len(longest.tokens))
    assert len(picked) == 24 and len({r.idx for r, _ in picked}) == 24
    assert {r.idx for r, _ in picked} >= {i for i in range(16)}
    assert all(k == 64 for _, k in picked[1:])
    run.ctx = SimpleNamespace(seed=7)
    assert {r.idx for r, _ in run.sample()} != {r.idx for r, _ in picked}


def test_resnet_answer_altered_is_not_correct(monkeypatch):
    import importlib

    mm = importlib.import_module("anakin_tpu_torch.kernels.matmul_int8")

    real = mm._matmul_int8

    def altered(a, b, *args, **kw):
        out = real(a, b, *args, **kw)
        if out.shape[1] == 1000:          # the classifier's logits
            out = out.clone()
            out[0, 7] += 50.0 * out[0].abs().max()
        return out

    monkeypatch.setattr(mm, "_matmul_int8", altered)
    assert _run(tiny.A)["correct"] is False


@pytest.mark.parametrize("name", [tiny.B, tiny.C])
def test_token_altered_is_not_correct(monkeypatch, name):
    from anakin_tpu_torch.runtime.decode_scheduler import DecodeScheduler

    real = DecodeScheduler._emit

    def altered(self, slot, tok):
        if slot.generated == 2:           # the third token of each request
            tok = (tok + 1) % self.cfg.vocab
        return real(self, slot, tok)

    monkeypatch.setattr(DecodeScheduler, "_emit", altered)
    assert _run(name)["correct"] is False


def test_traced_run_reads_its_layers_on_the_cpu():
    out = _run(tiny.B, trace=True)
    assert out["correct"] is True
    assert "window_step_ms.decode" in out["metrics"]
    assert out["device"]["window_s"] > 0


@pytest.mark.parametrize("name,wanted", [
    (tiny.A, ("enqueue_ms.offline", "mfu_pct.offline")),
    (tiny.C, ("admission_ms_per_ktok.prompt", "mfu_pct.prompt"))])
def test_traced_runs_read_their_span_metrics_on_the_cpu(name, wanted):
    out = _run(name, trace=True)
    assert out["correct"] is True
    for m in wanted:
        assert out["metrics"][m]["value"] > 0, m


@pytest.mark.gpu
@pytest.mark.parametrize("name", [tiny.A, tiny.B, tiny.C])
def test_cell_on_the_card(cuda_device, name):
    import subprocess
    import sys
    import json

    from portbench import spec

    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        name, "--seed", "7", "--seconds", "3", "--trace",
                        "0"], cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
