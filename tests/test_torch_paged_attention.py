"""Port parity of the paged-attention decode kernels' plain versions, of the
int8 KV quantiser, and of ``paged_forward``: the same numpy-drawn inputs go
through the JAX package (its Pallas kernels in interpret mode, and its
oracles) and through the port on the CPU.

Tolerances: ``FP32_ATOL`` (1e-4) in fp32 — the same arithmetic, summed in
another order; ``BF16_REL`` (2e-2 of max |ref|) in bf16 — the frameworks
round intermediates to bf16 at other points."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import BF16_REL, FP32_ATOL, assert_rel, configs, f32, jax_params, to_torch

from repro.core.quant import quantize_kv as j_quantize_kv
from repro.kernels.ops import paged_attention as j_pa
from repro.kernels.ops import paged_attention_q8 as j_pa_q8
from repro.kernels.ref import paged_attention_q8_ref as j_pa_q8_ref
from repro.kernels.ref import paged_attention_ref as j_pa_ref
from repro.models.model import paged_forward as j_paged_forward
from repro.models.model import paged_stack_decl as j_paged_stack_decl
from repro.sharding.rules import ParamDecl as JDecl
from repro_torch.core.quant import dequantize_kv, quantize_kv
from repro_torch.kernels import ops
from repro_torch.models.model import paged_forward as t_paged_forward
from repro_torch.models.model import paged_stack_decl as t_paged_stack_decl
from repro_torch.params import init_from_decls, tree_leaves


def _case(rng, B, H, KV, d, ps, maxP, lens, num_pages=None, hole=False):
    """Random pools and disjoint per-sequence page lists covering ``lens``
    (``hole``: the first sequence's second page released to -1)."""
    num_pages = num_pages or B * maxP
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, KV, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, KV, d)).astype(np.float32)
    perm = rng.permutation(num_pages)
    bt = np.full((B, maxP), -1, np.int32)
    used = 0
    for b in range(B):
        need = -(-int(lens[b]) // ps)
        bt[b, :need] = perm[used:used + need]
        used += need
    if hole:
        bt[0, 1] = -1
    return q, kp, vp, bt, np.asarray(lens, np.int32)


def _both(q, kp, vp, bt, sl, window=None, dtype=np.float32):
    jargs = [jnp.asarray(a.astype(dtype) if a.dtype == np.float32 else a) for a in (q, kp, vp, bt, sl)]
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    targs = [torch.from_numpy(a).to(tdt) if a.dtype == np.float32 else torch.from_numpy(a)
             for a in (q, kp, vp, bt, sl)]
    jk = j_pa(*jargs, window=window)
    jr = j_pa_ref(*jargs, window=window)
    t = ops.paged_attention(*targs, window=window)
    return t, jk, jr


@pytest.mark.parametrize("H,KV", [(4, 1), (4, 2), (8, 8), (6, 3)])
@pytest.mark.parametrize("ps", [1, 4, 8])
def test_plain_matches_jax_gqa_page_sweep(H, KV, ps):
    rng = np.random.default_rng(H * 100 + ps)
    B, d, maxP = 3, 32, 6
    lens = rng.integers(1, maxP * ps + 1, B)
    t, jk, jr = _both(*_case(rng, B, H, KV, d, ps, maxP, lens))
    np.testing.assert_allclose(f32(t), f32(jk), atol=FP32_ATOL)
    np.testing.assert_allclose(f32(t), f32(jr), atol=FP32_ATOL)


@pytest.mark.parametrize("window", [1, 3, 8, 64])
def test_plain_matches_jax_window(window):
    rng = np.random.default_rng(window)
    B, H, KV, d, ps, maxP = 2, 4, 2, 64, 4, 8
    lens = rng.integers(1, maxP * ps + 1, B)
    t, jk, jr = _both(*_case(rng, B, H, KV, d, ps, maxP, lens), window=window)
    np.testing.assert_allclose(f32(t), f32(jk), atol=FP32_ATOL)
    np.testing.assert_allclose(f32(t), f32(jr), atol=FP32_ATOL)


def test_released_pages_and_idle_row():
    """A -1 page in the middle of a table is masked, a row with seq_len 0
    gives exact zeros, and both agree with the JAX kernel."""
    rng = np.random.default_rng(7)
    q, kp, vp, bt, sl = _case(rng, 3, 8, 2, 32, 4, 5, [18, 9, 0], hole=True)
    t, jk, jr = _both(q, kp, vp, bt, sl)
    assert (bt[0] == -1).sum() > 0 and (bt[2] == -1).all()
    np.testing.assert_array_equal(f32(t)[2], 0.0)
    np.testing.assert_allclose(f32(t), f32(jk), atol=FP32_ATOL)
    np.testing.assert_allclose(f32(t), f32(jr), atol=FP32_ATOL)


@pytest.mark.parametrize("window", [None, 8])
def test_plain_matches_jax_bf16(window):
    rng = np.random.default_rng(11)
    q, kp, vp, bt, sl = _case(rng, 3, 8, 2, 64, 8, 6, [40, 7, 0], hole=True)
    t, jk, jr = _both(q, kp, vp, bt, sl, window=window, dtype=jnp.bfloat16)
    assert t.dtype == torch.bfloat16
    assert_rel(t, jk, BF16_REL)
    assert_rel(t, jr, BF16_REL)
    np.testing.assert_array_equal(f32(t)[2], 0.0)


def test_quantize_kv_identical_to_jax(rng):
    """Same int8 values and scales: fp32 division, round half to even,
    clip to +-127; round trip within half a step per element."""
    x = (rng.standard_normal((3, 5, 2, 32)) * rng.uniform(0.01, 10, (3, 5, 2, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero vector takes the eps scale
    jq, js = j_quantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (3, 5, 2, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = dequantize_kv(tq, ts).numpy()
    assert np.all(np.abs(back - x) <= ts.numpy() / 2 + 1e-6)


@pytest.mark.parametrize("window", [None, 5])
def test_plain_q8_matches_jax(window):
    rng = np.random.default_rng(21)
    q, kp, vp, bt, sl = _case(rng, 3, 8, 2, 32, 4, 6, [21, 13, 0], hole=True)
    kq, ks = j_quantize_kv(jnp.asarray(kp))
    vq, vs = j_quantize_kv(jnp.asarray(vp))
    jargs = (jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(bt), jnp.asarray(sl))
    jk = j_pa_q8(*jargs, window=window)
    jr = j_pa_q8_ref(*jargs, window=window)
    targs = [torch.from_numpy(np.asarray(a)) for a in jargs]
    t = ops.paged_attention_q8(*targs, window=window)
    assert t.dtype == torch.float32
    np.testing.assert_allclose(f32(t), f32(jk), atol=FP32_ATOL)
    np.testing.assert_allclose(f32(t), f32(jr), atol=FP32_ATOL)
    np.testing.assert_array_equal(f32(t)[2], 0.0)


@pytest.mark.parametrize("quant_kv", ["none", "int8"])
def test_paged_stack_decl_matches_jax(quant_kv):
    jcfg, tcfg = configs(fp32=False, quant_kv=quant_kv)
    jd = j_paged_stack_decl(jcfg, 9, 4)["stack"]["slot0"]["attn"]
    td = t_paged_stack_decl(tcfg, 9, 4)["stack"]["slot0"]["attn"]
    assert sorted(jd) == sorted(td)
    for k in jd:
        assert jd[k].shape == td[k].shape, k
        assert str(jnp.dtype(jd[k].dtype)) == str(td[k].dtype).replace("torch.", ""), k


@pytest.mark.parametrize("quant_kv", ["none", "int8"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_forward_chunk_then_decode(rng, quant_kv, use_kernel):
    """One prefill chunk (right-padded, with an idle row) and one decode
    step through both packages: logits and every written pool leaf agree
    (fp32)."""
    jcfg, tcfg = configs(quant_kv=quant_kv)
    jp = jax_params(jcfg)
    tp = to_torch(jp)
    ps, num_pages, maxP, S = 4, 13, 5, 8
    jpool = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype), j_paged_stack_decl(jcfg, num_pages, ps),
                         is_leaf=lambda d: isinstance(d, JDecl))
    tpool = init_from_decls(t_paged_stack_decl(tcfg, num_pages, ps), 0, "cpu")
    bt = np.full((2, maxP), -1, np.int32)
    bt[0, :3] = [5, 2, 9]
    toks = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    start = np.array([0, 0], np.int32)
    vlen = np.array([7, 0], np.int32)  # row 1 idle: its writes go to the trash page

    jl, jpool = j_paged_forward(jcfg, None, jp, jpool, jnp.asarray(toks), jnp.asarray(start),
                                jnp.asarray(bt), jnp.asarray(vlen), use_kernel=use_kernel)
    tl, tpool = t_paged_forward(tcfg, tp, tpool, torch.from_numpy(toks), torch.from_numpy(start),
                                torch.from_numpy(bt), torch.from_numpy(vlen), use_kernel=use_kernel)
    np.testing.assert_allclose(f32(tl)[0], f32(jl)[0], atol=FP32_ATOL)
    tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
    pos = np.array([7, 0], np.int32)
    act = np.array([1, 0], np.int32)
    jl, jpool = j_paged_forward(jcfg, None, jp, jpool, jnp.asarray(tok), jnp.asarray(pos),
                                jnp.asarray(bt), jnp.asarray(act), use_kernel=use_kernel)
    tl, tpool = t_paged_forward(tcfg, tp, tpool, torch.from_numpy(tok), torch.from_numpy(pos),
                                torch.from_numpy(bt), torch.from_numpy(act), use_kernel=use_kernel)
    np.testing.assert_allclose(f32(tl)[0], f32(jl)[0], atol=FP32_ATOL)
    live = [5, 2, 9]  # the trash page (12) holds whatever the idle row wrote last
    jattn, tattn = jpool["stack"]["slot0"]["attn"], tpool["stack"]["slot0"]["attn"]
    assert sorted(jattn) == sorted(tattn)
    for name in jattn:
        j, t = np.asarray(jattn[name])[:, live], tattn[name].numpy()[:, live]
        if t.dtype == np.int8:  # int8 codes may sit one step apart where fp32 sums differ
            assert np.abs(t.astype(np.int32) - j.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(t.astype(np.float32), j.astype(np.float32), atol=FP32_ATOL)
    untouched = [p for p in range(num_pages - 1) if p not in live]
    assert all(not t[:, untouched].any() for t in tree_leaves(tpool))


# ---------------------------------------------------------------------------
# The CUDA wrappers' host side: argument checks, the cluster split, the call
# ---------------------------------------------------------------------------

def _args(B=3, H=8, KV=2, d=64, ps=4, maxP=5, num_pages=16, pool_dtype=torch.bfloat16):
    """CPU tensors of the shapes the kernel takes (values unused)."""
    q = torch.zeros((B, H, d), dtype=torch.bfloat16)
    k = torch.zeros((num_pages, ps, KV, d), dtype=pool_dtype)
    v = torch.zeros((num_pages, ps, KV, d), dtype=pool_dtype)
    bt = torch.zeros((B, maxP), dtype=torch.int32)
    sl = torch.ones((B,), dtype=torch.int32)
    return dict(q=q, k_pool=k, v_pool=v, block_table=bt, seq_lens=sl)


def _misaligned(shape, dtype):
    """A contiguous tensor whose data starts 2 bytes past a 16-byte boundary."""
    return torch.zeros(int(np.prod(shape)) + 8, dtype=dtype)[1:int(np.prod(shape)) + 1].view(shape)


def _fault(a, fault):
    """The arguments of ``_args`` with one of them wrong; also returns ``out``."""
    B, H, d = a["q"].shape
    out = None
    if fault == "q dtype":
        a["q"] = a["q"].float()
    elif fault == "q shape":
        a["q"] = a["q"][0]
    elif fault == "q layout":
        a["q"] = torch.zeros((B, H, 2 * d), dtype=torch.bfloat16)[..., ::2]
    elif fault == "q align":
        a["q"] = _misaligned((B, H, d), torch.bfloat16)
    elif fault == "pool dtype":
        a["k_pool"] = a["k_pool"].float()
    elif fault == "pool device":
        a["v_pool"] = a["v_pool"].to("meta")
    elif fault == "pool layout":
        a["k_pool"] = a["k_pool"].transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "pool shape":
        a["v_pool"] = a["v_pool"][:-1].contiguous()
    elif fault == "pool align":
        a["k_pool"] = _misaligned(tuple(a["k_pool"].shape), a["k_pool"].dtype)
    elif fault == "G > 8":
        a["q"] = torch.zeros((B, 9 * a["k_pool"].shape[2], d), dtype=torch.bfloat16)
    elif fault == "head dim":
        a["q"] = torch.zeros((B, H, 96), dtype=torch.bfloat16)
        a["k_pool"] = torch.zeros(a["k_pool"].shape[:3] + (96,), dtype=a["k_pool"].dtype)
        a["v_pool"] = torch.zeros(a["v_pool"].shape[:3] + (96,), dtype=a["v_pool"].dtype)
    elif fault == "table shape":
        a["block_table"] = a["block_table"][:-1]
    elif fault == "table dtype":
        a["block_table"] = a["block_table"].float()
    elif fault == "table device":
        a["seq_lens"] = a["seq_lens"].to("meta")
    elif fault == "window":
        return a, None, 0
    elif fault == "out dtype":
        out = torch.zeros((B, H, d), dtype=torch.float32)
    elif fault == "out shape":
        out = torch.zeros((B, H + 1, d), dtype=torch.bfloat16)
    elif fault == "out device":
        out = torch.zeros((B, H, d), dtype=torch.bfloat16, device="meta")
    elif fault == "out layout":
        out = torch.zeros((B, H, 2 * d), dtype=torch.bfloat16)[..., ::2]
    return a, out, None


FAULTS = ["q dtype", "q shape", "q layout", "q align", "pool dtype", "pool device", "pool layout",
          "pool shape", "pool align", "G > 8", "head dim", "table shape", "table dtype", "table device",
          "window", "out dtype", "out shape", "out device", "out layout"]


@pytest.fixture
def no_library(monkeypatch):
    """Fail the test if a wrapper gets past its checks: no library load, no stream."""
    from repro_torch.kernels import _build

    def forbidden(*_a, **_k):
        raise AssertionError("reached past the argument checks")

    monkeypatch.setattr(_build, "load", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_cuda_wrapper_args_checked_before_any_library(no_library, q8, fault):
    """A wrong input or ``out=`` of either paged-attention wrapper raises
    ValueError from the argument checks, before a library is loaded or a
    stream looked up."""
    from repro_torch.kernels import paged_attention as tpa

    a, out, window = _fault(_args(pool_dtype=torch.int8 if q8 else torch.bfloat16), fault)
    with pytest.raises(ValueError, match="paged_attention"):
        if q8:
            num_pages, ps, KV = a["k_pool"].shape[:3]
            sc = torch.ones((num_pages, ps, KV, 1), dtype=torch.float32)
            tpa.paged_attention_q8_cuda(a["q"], a["k_pool"], a["v_pool"], sc, sc, a["block_table"],
                                        a["seq_lens"], window, 0.125, out=out)
        else:
            tpa.paged_attention_cuda(a["q"], a["k_pool"], a["v_pool"], a["block_table"], a["seq_lens"],
                                     window, 0.125, out=out)


@pytest.mark.parametrize("fault", ["shape", "dtype", "device", "layout"])
@pytest.mark.parametrize("which", ["k_scale", "v_scale"])
def test_cuda_wrapper_q8_scales_checked_before_any_library(no_library, which, fault):
    """The int8 wrapper's scale sidecars must be contiguous fp32
    (num_pages, ps, KV, 1) tensors on the device of q."""
    from repro_torch.kernels import paged_attention as tpa

    a = _args(pool_dtype=torch.int8)
    shape = tuple(a["k_pool"].shape[:3]) + (1,)
    good = torch.ones(shape, dtype=torch.float32)
    bad = {"shape": torch.ones(shape[:3] + (2,)), "dtype": torch.ones(shape, dtype=torch.bfloat16),
           "device": torch.ones(shape, device="meta"),
           "layout": torch.ones(shape[:3] + (2,))[..., :1]}[fault]
    scales = {"k_scale": good, "v_scale": good, which: bad}
    with pytest.raises(ValueError, match="paged_attention_q8"):
        tpa.paged_attention_q8_cuda(a["q"], a["k_pool"], a["v_pool"], scales["k_scale"], scales["v_scale"],
                                    a["block_table"], a["seq_lens"], None, 0.125)


@pytest.mark.parametrize("ps", [1, 2, 4, 8, 16, 24, 32, 64, 128])
def test_cluster_size_from_the_table_width(ps):
    """The host picks the cluster from maxP (and the page size) alone: a
    power of two up to the portable 8, never more blocks than a full row
    has units but for the power of two, and 8 once a row can hold 8 units."""
    from repro_torch.kernels import paged_attention as tpa

    for maxP in range(1, 601):
        cl = tpa.cluster_size(maxP, ps)
        units = maxP * -(-ps // tpa.UNIT)
        assert cl in (1, 2, 4, 8) and (cl == 8 or cl >= units) and (cl == 1 or cl // 2 < units)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [None, 7])
def test_cuda_wrapper_calls_the_kernel_with_its_arguments(monkeypatch, q8, window):
    """Past the checks, a wrapper loads the library once and calls its entry
    point with every argument its signature declares: the pool's page
    count, the cluster the host chose from maxP, the window (0 for none),
    and ``out`` when given, which it returns; the launch is counted."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as tpa

    calls = []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 0
            return entry

    class Stream:
        cuda_stream = 1234

    monkeypatch.setattr(_build, "load", lambda name, sigs: Lib() if name == "paged_attention" and sigs is tpa._SIGS
                        else None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    a = _args(pool_dtype=torch.int8 if q8 else torch.bfloat16, B=2, H=8, KV=2, d=64, ps=16, maxP=40, num_pages=9)
    out = torch.empty_like(a["q"])
    before = dict(tpa.LAUNCHES)
    if q8:
        sc = torch.ones((9, 16, 2, 1), dtype=torch.float32)
        got = tpa.paged_attention_q8_cuda(a["q"], a["k_pool"], a["v_pool"], sc, sc, a["block_table"].long(),
                                          a["seq_lens"], window, 0.125, out=out)
        name = "paged_attention_q8"
    else:
        got = tpa.paged_attention_cuda(a["q"], a["k_pool"], a["v_pool"], a["block_table"].long(), a["seq_lens"],
                                       window, 0.125, out=out)
        name = "paged_attention"
    assert got is out
    (entry, args), = calls
    assert entry == ("paged_attention_q8" if q8 else "paged_attention_bf16")
    assert len(args) == len(tpa._SIGS[entry])
    assert list(args[-11:-3]) == [2, 8, 2, 64, 9, 16, 40, tpa.cluster_size(40, 16)] and tpa.cluster_size(40, 16) == 8
    assert args[-3] == 0.125 and args[-2] == (window or 0) and args[-1] == 1234
    assert args[(7 if q8 else 5)] == out.data_ptr()
    assert tpa.LAUNCHES[name] == before[name] + 1
