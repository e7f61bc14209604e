"""Port parity: the ring-cache ServingEngine emits the same greedy tokens as
the JAX ring engine (fp32, sorted dispatcher, kernels on and off, with a
mid-stream slot refill), plus admission, option and device checks, and
``greedy=False`` against the JAX engine's in both cache modes."""
import numpy as np
import pytest
import torch

from torch_parity import configs, jax_params, to_torch

from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.resilience import FaultSpec, HangError, ShedError, faults
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine


def _requests(rng, cls, vocab):
    # 3 requests on 2 slots: the third is admitted mid-stream when the first
    # finishes; prompt lengths span two prefill buckets (16 and 32)
    spec = [(5, 3), (12, 6), (19, 4)]
    return [cls(rid=i, prompt=rng.integers(0, vocab, L).astype(np.int32), max_new_tokens=n)
            for i, (L, n) in enumerate(spec)]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ring_engine_tokens_identical_to_jax(use_kernel):
    jcfg, tcfg = configs()
    jp = jax_params(jcfg)
    jeng = JEngine(jcfg, jp, max_batch=2, max_seq=40, dispatcher="sorted", use_kernel=use_kernel)
    teng = TEngine(tcfg, to_torch(jp), max_batch=2, max_seq=40, dispatcher="sorted",
                   use_kernel=use_kernel, device="cpu")
    jout = jeng.run(_requests(np.random.default_rng(5), JRequest, jcfg.vocab_size))
    tout = teng.run(_requests(np.random.default_rng(5), TRequest, tcfg.vocab_size))
    assert tout == jout
    assert [len(tout[i]) for i in range(3)] == [3, 6, 4]
    assert len(teng.timings["prefill_s"]) == 3 and teng.timings["decode_s"]
    assert teng.health() == {**jeng.health(), "mode": "ring"}
    assert teng.kv_stats()["kv_bytes_resident"] == jeng.kv_stats()["kv_bytes_resident"]


def test_max_queue_sheds(rng):
    _, tcfg = configs(moe=False)
    eng = TEngine(tcfg, to_torch(jax_params(configs(moe=False)[0])), max_batch=1, max_seq=32,
                  max_queue=1, device="cpu")
    reqs = _requests(rng, TRequest, tcfg.vocab_size)
    eng.submit(reqs[0])
    with pytest.raises(ShedError):
        eng.submit(reqs[1])
    assert eng.health()["shed_count"] == 1


@pytest.mark.parametrize("kw", [dict(cache_mode="paged", mesh=object()), dict(mesh=object())])
def test_unported_engine_options_raise(kw):
    _, tcfg = configs(moe=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TEngine(tcfg, {}, device="cpu", **kw)


@pytest.mark.parametrize("mode", ["ring", "paged"])
def test_step_watchdog_trips_on_an_injected_hang(mode):
    """``step_timeout_s``: a ``serving.step`` hang of twice the budget
    raises ``HangError``, as in the JAX engine."""
    _, tcfg = configs(moe=False)
    kw = dict(cache_mode="paged", page_size=8) if mode == "paged" else {}
    eng = TEngine(tcfg, to_torch(jax_params(configs(moe=False)[0])), max_batch=2, max_seq=40, device="cpu",
                  step_timeout_s=0.1, **kw)
    eng.submit(_requests(np.random.default_rng(5), TRequest, tcfg.vocab_size)[0])
    with faults.inject(FaultSpec("serving.step", "hang", at=0, args={"seconds": 0.2})) as inj, \
            pytest.raises(HangError, match="wall budget"):
        eng.step()
    assert inj.fired == [("serving.step", "hang", 0)]


def test_step_watchdog_generous_budget_does_not_trip():
    """The same engine with a 60 s budget serves its requests to the end,
    with the tokens of an engine without the watchdog."""
    jcfg, tcfg = configs(moe=False)
    tp = to_torch(jax_params(jcfg))
    outs = [TEngine(tcfg, tp, max_batch=2, max_seq=40, device="cpu", **kw).run(
        _requests(np.random.default_rng(5), TRequest, tcfg.vocab_size)) for kw in ({}, dict(step_timeout_s=60.0))]
    assert outs[0] == outs[1] and [len(outs[1][i]) for i in range(3)] == [3, 6, 4]


@pytest.mark.parametrize("mode", ["ring", "paged"])
def test_greedy_false_tokens_identical_to_jax(mode):
    """``greedy=False`` is stored and never read, in both packages: the
    tokens are the JAX engine's with ``greedy=False``, and the greedy ones."""
    jcfg, tcfg = configs()
    jp = jax_params(jcfg)
    kw = dict(max_batch=2, max_seq=40, dispatcher="sorted")
    if mode == "paged":
        kw.update(cache_mode="paged", page_size=8, prefill_chunk=16)
    jout = JEngine(jcfg, jp, greedy=False, **kw).run(_requests(np.random.default_rng(5), JRequest, jcfg.vocab_size))
    teng = TEngine(tcfg, to_torch(jp), greedy=False, device="cpu", **kw)
    assert teng.greedy is False
    tout = teng.run(_requests(np.random.default_rng(5), TRequest, tcfg.vocab_size))
    greedy = TEngine(tcfg, to_torch(jp), device="cpu", **kw).run(
        _requests(np.random.default_rng(5), TRequest, tcfg.vocab_size))
    assert tout == jout == greedy and [len(tout[i]) for i in range(3)] == [3, 6, 4]


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal cannot be observed")
    _, tcfg = configs(moe=False)
    with pytest.raises(RuntimeError, match="cuda"):
        TEngine(tcfg, {}, device="cuda")


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main

    out = main(["--arch", "llama3-e8t2", "--smoke", "--requests", "2", "--max-new", "3",
                "--dispatcher", "sorted", "--use-kernel", "--device", "cpu"])
    assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    assert "served 2 requests (0 shed), 6 tokens" in capsys.readouterr().out
