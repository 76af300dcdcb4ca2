"""The traffic generators: deterministic for a seed, within their
parameters, and the same work for every seed in another order."""

import time

import numpy as np
import pytest

from portbench import loads, spec

MIXES = ["decode_closed16", "prompt_open"]


def _mix(name):
    return spec.load_cell(
        {"decode_closed16": "internlm2_1_8b_w4.decode_closed16",
         "prompt_open": "internlm2_1_8b_w4.prompt_open"}[name]).traffic


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    tr = _mix(mix)
    a = loads.plan_requests(tr, 2 ** 31 + 7, 92544)
    b = loads.plan_requests(tr, 2 ** 31 + 7, 92544)
    assert len(a) == tr["pool"]
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
        assert x.due == y.due


@pytest.mark.parametrize("mix", MIXES)
def test_sizes_within_parameters(mix):
    tr = _mix(mix)
    reqs = loads.plan_requests(tr, 11, 92544)
    P = np.array([len(r.prompt) for r in reqs])
    T = np.array([r.max_new for r in reqs])
    assert P.min() >= tr["prompt"]["min"] and P.max() <= tr["prompt"]["max"]
    assert T.min() >= tr["new_tokens"]["min"]
    assert T.max() <= tr["new_tokens"]["max"]
    assert abs(np.median(P) - tr["prompt"]["median"]) <= \
        0.1 * tr["prompt"]["median"]
    assert all(r.prompt.min() >= 0 and r.prompt.max() < 92544 for r in reqs)


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_serves_the_same_work(mix):
    tr = _mix(mix)
    a = loads.plan_requests(tr, 1, 1000)
    b = loads.plan_requests(tr, 2, 1000)
    assert [(len(r.prompt), r.max_new, r.due) for r in a] == \
        [(len(r.prompt), r.max_new, r.due) for r in b]
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    if "rate_per_s" in tr:
        d = np.diff([r.due for r in a])
        assert abs(d.mean() - 1 / tr["rate_per_s"]) < 0.15 / tr["rate_per_s"]


def test_open_loop_sends_when_due():
    tr = dict(_mix("prompt_open"), rate_per_s=200.0, pool=40)
    pool = loads.plan_requests(tr, 3, 100)
    sent = []

    class F:
        def add_done_callback(self, fn):
            pass

    def submit(prompt, max_new, on_token):
        sent.append(time.perf_counter())
        return F()

    t0 = time.perf_counter()
    gen = loads.start(tr, submit, pool, t0, t0 + 0.1)
    assert isinstance(gen, loads.OpenLoop) and gen.owes_all
    gen.join(5)
    assert len(gen.sent) == len(sent) == sum(r.due < t0 + 0.1 for r in pool)
    assert all(s.sent >= s.due - 1e-6 for s in gen.sent)
    assert max(gen.lateness) < 0.05


def test_closed_loop_keeps_one_request_a_client():
    from concurrent.futures import Future

    pool = loads.plan_requests(dict(_mix("decode_closed16"), pool=12), 5, 100)
    futs = []

    def submit(prompt, max_new, on_token):
        f = Future()
        futs.append(f)
        return f

    tr = dict(_mix("decode_closed16"), clients=3)
    t0 = time.perf_counter()
    gen = loads.start(tr, submit, pool, t0, t0 + 60)
    assert isinstance(gen, loads.ClosedLoop) and not gen.owes_all
    sent = gen.sent
    assert [r.idx for r in sent] == [0, 1, 2]
    assert [r.at_open for r in sent] == [True] * 3
    futs[1].set_result(np.zeros(3, np.int32))
    assert [r.idx for r in sent] == [0, 1, 2, 4]
    assert not sent[-1].at_open and sent[-1].due >= sent[0].due
    gen.settle(time.perf_counter())
    assert futs[0].cancelled() and futs[1].done()


def test_bursty_arrivals_keep_the_rate():
    tr = dict(_mix("prompt_open"), rate_per_s=3.0, pool=4000)
    plain = np.diff([r.due for r in loads.plan_requests(tr, 1, 100)])
    tr["burst_cv"] = 3.0
    bursty = np.diff([r.due for r in loads.plan_requests(tr, 1, 100)])
    for gaps, cv in ((plain, 1.0), (bursty, 3.0)):
        assert abs(gaps.mean() - 1 / 3.0) < 0.1 / 3.0
        assert abs(gaps.std() / gaps.mean() - cv) < 0.15 * cv


def test_every_generator_is_found_by_name():
    names = {spec.load_cell(w["name"]).traffic["generator"]
             for w in spec.load_benchmark()["workloads"]}
    assert names - {"offline"} <= set(loads.GENERATORS)
