"""Port parity for the grouped GEMM backward (kernels #5-#7): the plain
backward passes and the ``GroupedGemm`` autograd Function against the JAX
package's Pallas backward kernels in interpret mode, on the same numpy
inputs.

Tolerances: fp32 inputs ``FP32_ATOL`` scaled by the output's size (the
same fp32 arithmetic, only the summation order differs); bf16 inputs
``BF16_REL`` of max |ref| (the frameworks round intermediates at other
points). Padding rows and empty experts must be exactly zero on both sides.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel, f32

from repro.core.dispatch.sorted import aligned_rows
from repro.kernels import expert_gemm as jeg
from repro.kernels import ops as jops
from repro_torch.kernels import expert_gemm as teg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

CASES = [  # (E, D, F, group_sizes, row_block)
    (4, 32, 64, (16, 0, 7, 9), 8),  # an empty expert, partial tiles
    (3, 64, 128, (130, 0, 13), 128),  # a group past one 128-row tile, partial tiles
]


def _case(rng, E, D, F, gs, bc, dtype):
    gs = np.asarray(gs, np.int32)
    N_pad = aligned_rows(int(gs.sum()), E, bc)
    xs = np.full((N_pad, D), 7.5, np.float32)  # poisoned padding rows
    dy = np.full((N_pad, D), 7.5, np.float32)
    valid = np.zeros(N_pad, bool)
    padded = (gs + bc - 1) // bc * bc
    starts = np.cumsum(padded) - padded
    for e in range(E):
        xs[starts[e]:starts[e] + gs[e]] = rng.standard_normal((gs[e], D)) * 0.3
        dy[starts[e]:starts[e] + gs[e]] = rng.standard_normal((gs[e], D))
        valid[starts[e]:starts[e] + gs[e]] = True
    ws = [(rng.standard_normal(s) * 0.05).astype(np.float32) for s in ((E, D, F), (E, D, F), (E, F, D))]
    jargs = [jnp.asarray(a, dtype) for a in (xs, dy, *ws)]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (xs, dy, *ws)]
    return jargs, targs, gs, valid


def _close(out, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(f32(out), f32(ref), atol=1e-5 * max(1.0, float(np.abs(f32(ref)).max())))
    else:
        assert_rel(out, ref)


def _jax_bwd_passes(monkeypatch, xs, dy, wg, wu, wd, gs, bc):
    """``_grouped_bwd_impl`` in interpret mode, with the outputs of its first
    ``pallas_call`` (h, dg, du) captured as it returns them."""
    captured = []
    real = jeg.pl

    def spy(*a, **k):
        call = real.pallas_call(*a, **k)

        def run(*args):
            out = call(*args)
            captured.append(out)
            return out
        return run

    proxy = types.SimpleNamespace(**{n: getattr(real, n) for n in dir(real) if not n.startswith("__")})
    proxy.pallas_call = spy
    monkeypatch.setattr(jeg, "pl", proxy)
    dx, dwg, dwu, dwd = jeg._grouped_bwd_impl(xs, dy, wg, wu, wd, jnp.asarray(gs), (bc, 512, 512), True)
    return captured[0], (dx, dwg, dwu, dwd)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_passes_match_jax_kernels(rng, monkeypatch, case, dtype):
    E, D, F, gs_t, bc = case
    jargs, targs, gs, valid = _case(rng, E, D, F, gs_t, bc, dtype)
    (jh, jdg, jdu), jgrads = _jax_bwd_passes(monkeypatch, *jargs, gs, bc)
    xs, dy, wg, wu, wd = targs
    tgs = torch.from_numpy(gs)
    th, tdg, tdu = tref.grouped_bwd_dh_ref(xs, dy, wg, wu, wd, tgs, bc)
    for t, j in ((th, jh), (tdg, jdg), (tdu, jdu)):
        assert f32(t)[~valid].max(initial=0) == 0 and f32(t)[~valid].min(initial=0) == 0
        _close(f32(t)[valid], f32(j)[valid], dtype)
    # each later pass fed the JAX pass's own inputs, then the chained whole
    as_t = lambda a: torch.from_numpy(np.array(f32(a))).to(getattr(torch, dtype))
    tdx = tref.grouped_bwd_dx_ref(as_t(jdg), as_t(jdu), wg, wu, tgs, bc)
    _close(f32(tdx)[valid], f32(jgrads[0])[valid], dtype)
    tw = tref.grouped_bwd_wgrad_ref(xs, dy, as_t(jh), as_t(jdg), as_t(jdu), tgs, bc, wg.dtype)
    for t, j in zip(tw, jgrads[1:]):
        _close(t, j, dtype)
    chained = teg.grouped_gemm_bwd(xs, dy, wg, wu, wd, tgs, bc)
    assert f32(chained[0])[~valid].max(initial=0) == 0 and f32(chained[0])[~valid].min(initial=0) == 0
    for t, j in zip(chained, jgrads):
        _close(t, j, dtype)
    for e in np.nonzero(gs == 0)[0]:
        for t in chained[1:]:
            assert not t[e].any()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_gemm_function_matches_jax_vjp(rng, case, dtype):
    """``ops.grouped_gemm`` forward and autograd backward (the Function the
    card runs, here on its plain versions) vs ``jax.vjp`` of the JAX
    kernel path."""
    E, D, F, gs_t, bc = case
    jargs, targs, gs, valid = _case(rng, E, D, F, gs_t, bc, dtype)
    jxs, jdy, jwg, jwu, jwd = jargs
    jy, vjp = jax.vjp(lambda *a: jops.grouped_gemm(*a, jnp.asarray(gs), row_block=bc), jxs, jwg, jwu, jwd)
    jg = vjp(jdy)
    xs, dy, wg, wu, wd = (t.clone().requires_grad_(i != 1) for i, t in enumerate(targs))
    ty = tops.grouped_gemm(xs, wg, wu, wd, torch.from_numpy(gs), row_block=bc)
    _close(f32(ty)[valid], f32(jy)[valid], dtype)
    ty.backward(dy)
    for t, j in zip((xs.grad, wg.grad, wu.grad, wd.grad), jg):
        assert t.dtype == xs.dtype
        _close(t, j, dtype)
    assert f32(xs.grad)[~valid].max(initial=0) == 0 and f32(xs.grad)[~valid].min(initial=0) == 0


def test_function_saves_only_its_inputs(rng):
    """The recompute contract, as the JAX ``custom_vjp`` keeps it: the
    forward saves xs, the three weight stacks and group_sizes, never an
    (N_pad, F) intermediate."""
    E, D, F, gs_t, bc = CASES[0]
    jargs, targs, gs, _ = _case(rng, E, D, F, gs_t, bc, "float32")
    saved = teg.grouped_gemm_residuals(targs[0], *targs[2:], torch.from_numpy(gs), row_block=bc)
    shapes = [s for s, _ in saved]
    N_pad = targs[0].shape[0]
    assert (N_pad, F) not in shapes
    assert sorted(shapes) == sorted([(N_pad, D), (E, D, F), (E, D, F), (E, F, D), (E,)])
    jres = jeg.grouped_gemm_residuals(jargs[0], *jargs[2:], jnp.asarray(gs), blocks=(bc, 512, 512))
    assert sorted(shapes) == sorted(tuple(r.shape) for r in jres)


def test_backward_on_a_cuda_tensor_never_falls_back():
    """The Function's backward dispatches on the device: a tensor that is
    neither CPU nor CUDA is refused rather than run on the plain path."""
    x = torch.zeros((8, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        teg.grouped_gemm_bwd(x, x, x, x, x, x, 8)


def _misaligned(shape, dtype=torch.bfloat16):
    """A contiguous tensor whose data starts 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


def _bad(shape, fault):
    if fault == "shape":
        return torch.zeros(shape[:-1] + (shape[-1] + 128,), dtype=torch.bfloat16)
    if fault == "dtype":
        return torch.zeros(shape, dtype=torch.float32)
    if fault == "layout":
        return torch.zeros(shape[:-1] + (2 * shape[-1],), dtype=torch.bfloat16)[..., ::2]
    if fault == "align":
        return _misaligned(shape)
    return torch.zeros(shape, dtype=torch.bfloat16, device="meta")


@pytest.mark.parametrize("fault", ["shape", "dtype", "layout", "device", "align"])
@pytest.mark.parametrize("arg", ["out", "du"])
def test_bwd_dx_args_checked_before_any_library(monkeypatch, arg, fault):
    """A wrong ``out=`` (or input) of the dx kernel #6's wrapper raises
    ValueError from the argument checks, before a library is loaded or a
    stream looked up."""
    from repro_torch.kernels import _build

    def forbidden(*_a, **_k):
        raise AssertionError("reached past the argument checks")

    monkeypatch.setattr(_build, "load", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    E, N_pad, D, F = 2, 256, 256, 128
    dg = torch.zeros((N_pad, F), dtype=torch.bfloat16)
    w = torch.zeros((E, D, F), dtype=torch.bfloat16)
    tg, tr = torch.zeros(2, dtype=torch.int32), torch.full((2,), 128, dtype=torch.int32)
    if arg == "du":
        with pytest.raises(ValueError, match="grouped_bwd_dx"):
            teg.bwd_dx_cuda(dg, _bad((N_pad, F), fault), w, w, tg, tr)
    else:
        with pytest.raises(ValueError, match="grouped_bwd_dx: out" if fault != "align" else "16-byte"):
            teg.bwd_dx_cuda(dg, dg, w, w, tg, tr, out=_bad((N_pad, D), fault))


@pytest.mark.parametrize("fault", ["shape", "dtype", "layout", "device", "align"])
@pytest.mark.parametrize("arg", ["out", "h"])
def test_grouped_down_args_checked_before_any_library(monkeypatch, arg, fault):
    """A wrong ``out=`` (or input) of the sorted down kernel #4's wrapper
    raises ValueError from the argument checks, before a library is loaded
    or a stream looked up."""
    from repro_torch.kernels import _build

    def forbidden(*_a, **_k):
        raise AssertionError("reached past the argument checks")

    monkeypatch.setattr(_build, "load", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    E, N_pad, D, F = 2, 256, 256, 128
    h = torch.zeros((N_pad, F), dtype=torch.bfloat16)
    wd = torch.zeros((E, F, D), dtype=torch.bfloat16)
    tg, tr = torch.zeros(2, dtype=torch.int32), torch.full((2,), 128, dtype=torch.int32)
    if arg == "h":
        with pytest.raises(ValueError, match="grouped_down"):
            teg.down_cuda(_bad((N_pad, F), fault), wd, tg, tr)
    else:
        with pytest.raises(ValueError, match="grouped_down: out" if fault != "align" else "16-byte"):
            teg.down_cuda(h, wd, tg, tr, out=_bad((N_pad, D), fault))


@pytest.mark.parametrize("fault", ["shape", "dtype", "device"])
def test_grouped_down_tiles_checked_before_any_library(monkeypatch, fault):
    """Per-tile metadata of #4 that is not a contiguous int32 (N_pad / 128,)
    tensor on h's device raises ValueError before any library loads."""
    from repro_torch.kernels import _build

    def forbidden(*_a, **_k):
        raise AssertionError("reached past the argument checks")

    monkeypatch.setattr(_build, "load", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    E, N_pad, D, F = 2, 256, 256, 128
    h = torch.zeros((N_pad, F), dtype=torch.bfloat16)
    wd = torch.zeros((E, F, D), dtype=torch.bfloat16)
    tg = torch.zeros(2, dtype=torch.int32)
    tr = {"shape": torch.full((3,), 128, dtype=torch.int32), "dtype": torch.full((2,), 128, dtype=torch.int64),
          "device": torch.full((2,), 128, dtype=torch.int32, device="meta")}[fault]
    with pytest.raises(ValueError, match="grouped_down: tile_rows"):
        teg.down_cuda(h, wd, tg, tr)


@pytest.mark.parametrize("fault", ["shape", "dtype", "layout", "device", "align"])
@pytest.mark.parametrize("arg", ["out", "dy"])
def test_bwd_dh_args_checked_before_any_library(monkeypatch, arg, fault):
    """A wrong ``out=`` (one of its three tensors) or input of the dh
    kernel #5's wrapper raises ValueError from the argument checks, before
    a library is loaded or a stream looked up."""
    from repro_torch.kernels import _build

    def forbidden(*_a, **_k):
        raise AssertionError("reached past the argument checks")

    monkeypatch.setattr(_build, "load", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    E, N_pad, D, F = 2, 256, 256, 128
    xs = torch.zeros((N_pad, D), dtype=torch.bfloat16)
    w, wd = torch.zeros((E, D, F), dtype=torch.bfloat16), torch.zeros((E, F, D), dtype=torch.bfloat16)
    tg, tr = torch.zeros(2, dtype=torch.int32), torch.full((2,), 128, dtype=torch.int32)
    if arg == "dy":
        with pytest.raises(ValueError, match="grouped_bwd_dh"):
            teg.bwd_dh_cuda(xs, _bad((N_pad, D), fault), w, w, wd, tg, tr)
    else:
        ok = torch.zeros((N_pad, F), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="grouped_bwd_dh: out" if fault != "align" else "16-byte"):
            teg.bwd_dh_cuda(xs, xs, w, w, wd, tg, tr, out=(ok, _bad((N_pad, F), fault), ok))


@pytest.mark.parametrize("fault", ["shape", "dtype", "layout", "device", "align"])
@pytest.mark.parametrize("arg", ["out", "dg"])
def test_bwd_wgrad_args_checked_before_any_library(monkeypatch, arg, fault):
    """A wrong ``out=`` (one of its three tensors) or input of the wgrad
    kernel #7's wrapper raises ValueError from the argument checks, before
    a library is loaded or a stream looked up."""
    from repro_torch.kernels import _build

    def forbidden(*_a, **_k):
        raise AssertionError("reached past the argument checks")

    monkeypatch.setattr(_build, "load", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    E, N_pad, D, F = 2, 256, 256, 128
    xs = torch.zeros((N_pad, D), dtype=torch.bfloat16)
    h = torch.zeros((N_pad, F), dtype=torch.bfloat16)
    gs = torch.tensor([100, 28], dtype=torch.int32)
    if arg == "dg":
        with pytest.raises(ValueError, match="grouped_bwd_wgrad"):
            teg.bwd_wgrad_cuda(xs, xs, h, _bad((N_pad, F), fault), h, gs)
    else:
        dw = torch.zeros((E, D, F), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="grouped_bwd_wgrad: out" if fault != "align" else "16-byte"):
            teg.bwd_wgrad_cuda(xs, xs, h, h, h, gs, out=(dw, dw, _bad((E, F, D), fault)))
