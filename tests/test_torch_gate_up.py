"""Argument checks of the sorted bf16 gate/up wrapper ``gate_up_cuda`` (#3),
the fused int8 gate/up wrapper ``fused_gate_up_q8_cuda`` (#14) and the
fused bf16 one ``fused_gate_up_cuda`` (#12): on the CPU, each wrong input
or ``out=`` (dtype, shape, layout, device, or a base the kernel cannot
read: off the 16-byte boundary that TMA and the 16-byte row copies need,
or a scale off the 4-byte boundary of its bf16 pairs) raises ValueError
before a library is loaded or a stream looked up, and arguments the
kernels take reach the library load. #14 and #12 gather their rows from
the token-major x into the slot and are otherwise #10's and #3's kernel,
so their plain versions are held here to #10's and #3's on the scattered
buffer, bit for bit: the CPU mirror of ``chip_smoke.py``'s check that the
kernels' h agree bit for bit on the card. The kernels' arithmetic is held against the JAX
package in ``test_torch_moe.py``, ``test_torch_quant.py`` and
``test_torch_fused.py`` (through their plain versions).
"""
import numpy as np
import pytest
import torch

from repro_torch.config import MoEConfig
from repro_torch.core.dispatch import SortedDispatcher
from repro_torch.kernels import _build
from repro_torch.kernels import expert_gemm as teg
from repro_torch.kernels import ref

E, N_PAD, D, F, T = 2, 256, 256, 128, 4


def _misaligned(shape, dtype, by: int = 1):
    """A contiguous tensor whose data starts ``by`` elements past an aligned base."""
    n = int(np.prod(shape))
    return torch.zeros(n + by, dtype=dtype)[by:].view(shape)


def _tiles():
    return dict(tile_group=torch.zeros(N_PAD // 128, dtype=torch.int32),
                tile_rows=torch.full((N_PAD // 128,), 128, dtype=torch.int32))


def _gate_up_args(**faults):
    """#3's wrapper arguments at a small shape (E 2, N_pad 256, D 256, F
    128), each replaced by ``faults[name]`` where given."""
    args = dict(xs=torch.zeros((N_PAD, D), dtype=torch.bfloat16),
                w_gate=torch.zeros((E, D, F), dtype=torch.bfloat16),
                w_up=torch.zeros((E, D, F), dtype=torch.bfloat16), **_tiles(), out=None)
    args.update(faults)
    return args


def _fused_bf16_args(**faults):
    """#12's wrapper arguments: #14's with bf16 weights and no scales."""
    args = dict(x=torch.zeros((T, D), dtype=torch.bfloat16), w_gate=torch.zeros((E, D, F), dtype=torch.bfloat16),
                w_up=torch.zeros((E, D, F), dtype=torch.bfloat16), tok_pad=torch.zeros(N_PAD, dtype=torch.int32),
                **_tiles(), out=None)
    args.update(faults)
    return args


def _fused_args(**faults):
    """#14's wrapper arguments at the same shape from T 4 tokens (x (4,
    256), tok_pad (256,)), each replaced by ``faults[name]`` where given."""
    args = dict(x=torch.zeros((T, D), dtype=torch.bfloat16), w_gate=torch.zeros((E, D, F), dtype=torch.int8),
                w_up=torch.zeros((E, D, F), dtype=torch.int8), s_gate=torch.zeros((E, F), dtype=torch.bfloat16),
                s_up=torch.zeros((E, F), dtype=torch.bfloat16), tok_pad=torch.zeros(N_PAD, dtype=torch.int32),
                **_tiles(), out=None)
    args.update(faults)
    return args


_TILE_FAULTS = {
    ("tile_group", "shape"): torch.zeros(3, dtype=torch.int32),
    ("tile_group", "dtype"): torch.zeros(2, dtype=torch.int64),
    ("tile_group", "layout"): torch.zeros(4, dtype=torch.int32)[::2],
    ("tile_group", "device"): torch.zeros(2, dtype=torch.int32, device="meta"),
    ("tile_rows", "shape"): torch.full((1,), 128, dtype=torch.int32),
    ("tile_rows", "dtype"): torch.full((2,), 128, dtype=torch.int64),
    ("tile_rows", "device"): torch.full((2,), 128, dtype=torch.int32, device="meta"),
}

_OUT_FAULTS = {
    ("out", "shape"): torch.zeros((N_PAD, D), dtype=torch.bfloat16),
    ("out", "dtype"): torch.zeros((N_PAD, F)),
    ("out", "layout"): torch.zeros((N_PAD, 2 * F), dtype=torch.bfloat16)[:, ::2],
    ("out", "device"): torch.zeros((N_PAD, F), dtype=torch.bfloat16, device="meta"),
    ("out", "align"): _misaligned((N_PAD, F), torch.bfloat16),
}

_GATE_UP_FAULTS = {
    ("xs", "shape"): torch.zeros((N_PAD, 2 * D), dtype=torch.bfloat16),
    ("xs", "rows"): torch.zeros((200, D), dtype=torch.bfloat16),
    ("xs", "rank"): torch.zeros((1, N_PAD, D), dtype=torch.bfloat16),
    ("xs", "dtype"): torch.zeros((N_PAD, D)),
    ("xs", "layout"): torch.zeros((N_PAD, 2 * D), dtype=torch.bfloat16)[:, ::2],
    ("xs", "device"): torch.zeros((N_PAD, D), dtype=torch.bfloat16, device="meta"),
    ("xs", "align"): _misaligned((N_PAD, D), torch.bfloat16),
    ("w_gate", "shape"): torch.zeros((E, 2 * D, F), dtype=torch.bfloat16),
    ("w_gate", "width"): dict(w_gate=torch.zeros((E, D, 64), dtype=torch.bfloat16),
                              w_up=torch.zeros((E, D, 64), dtype=torch.bfloat16)),
    ("w_gate", "rank"): torch.zeros((D, F), dtype=torch.bfloat16),
    ("w_gate", "dtype"): torch.zeros((E, D, F), dtype=torch.int8),
    ("w_gate", "layout"): torch.zeros((E, D, 2 * F), dtype=torch.bfloat16)[..., ::2],
    ("w_gate", "device"): torch.zeros((E, D, F), dtype=torch.bfloat16, device="meta"),
    ("w_gate", "align"): _misaligned((E, D, F), torch.bfloat16),
    ("w_up", "shape"): torch.zeros((E + 1, D, F), dtype=torch.bfloat16),
    ("w_up", "dtype"): torch.zeros((E, D, F)),
    ("w_up", "layout"): torch.zeros((E, F, D), dtype=torch.bfloat16).transpose(1, 2),
    ("w_up", "device"): torch.zeros((E, D, F), dtype=torch.bfloat16, device="meta"),
    ("w_up", "align"): _misaligned((E, D, F), torch.bfloat16),
    **_TILE_FAULTS,
    **_OUT_FAULTS,
}

_X_FAULTS = {
    ("x", "width"): torch.zeros((T, 2 * D), dtype=torch.bfloat16),
    ("x", "rank"): torch.zeros((1, T, D), dtype=torch.bfloat16),
    ("x", "dtype"): torch.zeros((T, D)),
    ("x", "layout"): torch.zeros((T, 2 * D), dtype=torch.bfloat16)[:, ::2],
    ("x", "device"): torch.zeros((T, D), dtype=torch.bfloat16, device="meta"),
    ("x", "align"): _misaligned((T, D), torch.bfloat16),
}

_TOK_PAD_FAULTS = {
    ("tok_pad", "rows"): torch.zeros(200, dtype=torch.int32),
    ("tok_pad", "length"): torch.zeros(3 * 128, dtype=torch.int32),
    ("tok_pad", "rank"): torch.zeros((N_PAD, 1), dtype=torch.int32),
    ("tok_pad", "dtype"): torch.zeros(N_PAD, dtype=torch.int64),
    ("tok_pad", "layout"): torch.zeros(2 * N_PAD, dtype=torch.int32)[::2],
    ("tok_pad", "device"): torch.zeros(N_PAD, dtype=torch.int32, device="meta"),
}

_FUSED_BF16_FAULTS = {
    **_X_FAULTS,
    ("w_gate", "shape"): torch.zeros((E, 2 * D, F), dtype=torch.bfloat16),
    ("w_gate", "width"): dict(w_gate=torch.zeros((E, D, 64), dtype=torch.bfloat16),
                              w_up=torch.zeros((E, D, 64), dtype=torch.bfloat16)),
    ("w_gate", "rank"): torch.zeros((D, F), dtype=torch.bfloat16),
    ("w_gate", "dtype"): torch.zeros((E, D, F), dtype=torch.int8),
    ("w_gate", "layout"): torch.zeros((E, D, 2 * F), dtype=torch.bfloat16)[..., ::2],
    ("w_gate", "device"): torch.zeros((E, D, F), dtype=torch.bfloat16, device="meta"),
    ("w_gate", "align"): _misaligned((E, D, F), torch.bfloat16),
    ("w_up", "shape"): torch.zeros((E + 1, D, F), dtype=torch.bfloat16),
    ("w_up", "dtype"): torch.zeros((E, D, F)),
    ("w_up", "layout"): torch.zeros((E, F, D), dtype=torch.bfloat16).transpose(1, 2),
    ("w_up", "device"): torch.zeros((E, D, F), dtype=torch.bfloat16, device="meta"),
    ("w_up", "align"): _misaligned((E, D, F), torch.bfloat16),
    **_TOK_PAD_FAULTS,
    **_TILE_FAULTS,
    **_OUT_FAULTS,
}

_FUSED_FAULTS = {
    **_X_FAULTS,
    ("w_gate", "shape"): torch.zeros((E, 2 * D, F), dtype=torch.int8),
    ("w_gate", "width"): dict(w_gate=torch.zeros((E, D, 64), dtype=torch.int8),
                              w_up=torch.zeros((E, D, 64), dtype=torch.int8),
                              s_gate=torch.zeros((E, 64), dtype=torch.bfloat16),
                              s_up=torch.zeros((E, 64), dtype=torch.bfloat16)),
    ("w_gate", "dtype"): torch.zeros((E, D, F), dtype=torch.bfloat16),
    ("w_gate", "layout"): torch.zeros((E, D, 2 * F), dtype=torch.int8)[..., ::2],
    ("w_gate", "device"): torch.zeros((E, D, F), dtype=torch.int8, device="meta"),
    ("w_gate", "align"): _misaligned((E, D, F), torch.int8),
    ("w_up", "shape"): torch.zeros((E + 1, D, F), dtype=torch.int8),
    ("w_up", "dtype"): torch.zeros((E, D, F), dtype=torch.uint8),
    ("w_up", "layout"): torch.zeros((E, F, D), dtype=torch.int8).transpose(1, 2),
    ("w_up", "device"): torch.zeros((E, D, F), dtype=torch.int8, device="meta"),
    ("w_up", "align"): _misaligned((E, D, F), torch.int8),
    ("s_gate", "shape"): torch.zeros((E, D), dtype=torch.bfloat16),
    ("s_gate", "dtype"): torch.zeros((E, F)),
    ("s_gate", "layout"): torch.zeros((E, 2 * F), dtype=torch.bfloat16)[:, ::2],
    ("s_gate", "device"): torch.zeros((E, F), dtype=torch.bfloat16, device="meta"),
    ("s_gate", "align"): _misaligned((E, F), torch.bfloat16),
    ("s_up", "shape"): torch.zeros((E, F, 1), dtype=torch.bfloat16),
    ("s_up", "dtype"): torch.zeros((E, F), dtype=torch.float16),
    ("s_up", "device"): torch.zeros((E, F), dtype=torch.bfloat16, device="meta"),
    ("s_up", "align"): _misaligned((E, F), torch.bfloat16),
    **_TOK_PAD_FAULTS,
    **_TILE_FAULTS,
    **_OUT_FAULTS,
}


def _faulty(args_fn, arg, fault):
    """The arguments with ``fault`` in place of ``arg`` (a dict: several
    replaced together, so that only the named fault remains)."""
    return args_fn(**(fault if isinstance(fault, dict) else {arg: fault}))


def _forbid_library(monkeypatch, stream: bool = True):
    def forbidden(*_a, **_k):
        raise AssertionError("reached past the argument checks")

    monkeypatch.setattr(_build, "load", forbidden)
    if stream:
        monkeypatch.setattr(torch.cuda, "current_stream", forbidden)


def _gate_up(a):
    return teg.gate_up_cuda(a["xs"], a["w_gate"], a["w_up"], a["tile_group"], a["tile_rows"], out=a["out"])


def _fused(a):
    return teg.fused_gate_up_q8_cuda(a["x"], a["w_gate"], a["w_up"], a["s_gate"], a["s_up"], a["tok_pad"],
                                     a["tile_group"], a["tile_rows"], out=a["out"])


def _fused_bf16(a):
    return teg.fused_gate_up_cuda(a["x"], a["w_gate"], a["w_up"], a["tok_pad"], a["tile_group"], a["tile_rows"],
                                  out=a["out"])


@pytest.mark.parametrize("arg,fault", sorted(_GATE_UP_FAULTS))
def test_gate_up_args_checked_before_any_library(monkeypatch, arg, fault):
    """A wrong input or ``out=`` of #3's wrapper raises ValueError from the
    argument checks, before a library is loaded or a stream looked up."""
    _forbid_library(monkeypatch)
    with pytest.raises(ValueError, match="grouped_gate_up"):
        _gate_up(_faulty(_gate_up_args, arg, _GATE_UP_FAULTS[(arg, fault)]))


@pytest.mark.parametrize("arg,fault", sorted(_FUSED_FAULTS))
def test_fused_gate_up_q8_args_checked_before_any_library(monkeypatch, arg, fault):
    """A wrong input or ``out=`` of #14's wrapper raises ValueError from the
    argument checks, before a library is loaded or a stream looked up."""
    _forbid_library(monkeypatch)
    with pytest.raises(ValueError, match="grouped_gate_up_fused_q8"):
        _fused(_faulty(_fused_args, arg, _FUSED_FAULTS[(arg, fault)]))


@pytest.mark.parametrize("arg,fault", sorted(_FUSED_BF16_FAULTS))
def test_fused_gate_up_args_checked_before_any_library(monkeypatch, arg, fault):
    """A wrong input or ``out=`` of #12's wrapper raises ValueError from the
    argument checks, before a library is loaded or a stream looked up."""
    _forbid_library(monkeypatch)
    with pytest.raises(ValueError, match="grouped_gate_up_fused:"):
        _fused_bf16(_faulty(_fused_bf16_args, arg, _FUSED_BF16_FAULTS[(arg, fault)]))


@pytest.mark.parametrize("out", [False, True])
@pytest.mark.parametrize("kernel", ["gate_up", "fused_q8", "fused"])
def test_gate_up_good_args_reach_the_library(monkeypatch, kernel, out):
    """Arguments the kernels take (with or without ``out=``) pass every
    check of #3's, #14's and #12's wrappers and reach the library load."""
    _forbid_library(monkeypatch, stream=False)
    o = torch.zeros((N_PAD, F), dtype=torch.bfloat16) if out else None
    call, args = {"gate_up": (_gate_up, _gate_up_args), "fused_q8": (_fused, _fused_args),
                  "fused": (_fused_bf16, _fused_bf16_args)}[kernel]
    with pytest.raises(AssertionError, match="reached past"):
        call(args(out=o))


def _scattered_case(seed: int, row_block: int, q8: bool):
    """A small sorted routing of 37 tokens over 4 experts (top-2) at
    ``row_block``: (x, weights (int8 with ``q8``, else bf16), scales or
    None, group sizes, the fused tables, and x scattered into the sorted
    (N_pad, D) buffer)."""
    rng = np.random.default_rng(seed)
    E_, T_, k, D_, F_ = 4, 37, 2, 64, 48
    idx = torch.from_numpy(np.stack([rng.choice(E_, size=k, replace=False) for _ in range(T_)]))
    gates = torch.from_numpy(rng.uniform(0.2, 1.0, size=(T_, k)).astype(np.float32))
    d = SortedDispatcher(None, MoEConfig(num_experts=E_, top_k=k, dispatcher="sorted"))
    token, slot, dest, gate_sorted, gs = d._indices(idx, gates, row_block)
    x = torch.from_numpy(rng.standard_normal((T_, D_)).astype(np.float32)).bfloat16()
    if q8:
        wg, wu = (torch.from_numpy(rng.integers(-127, 128, size=(E_, D_, F_), dtype=np.int8)) for _ in range(2))
        scales = tuple(torch.from_numpy(rng.uniform(1e-3, 2e-2, size=(E_, F_)).astype(np.float32)).bfloat16()
                       for _ in range(2))
    else:
        wg, wu = (torch.from_numpy((rng.standard_normal((E_, D_, F_)) * D_ ** -0.5).astype(np.float32)).bfloat16()
                  for _ in range(2))
        scales = None
    tables = teg.fused_tables(wg, gs, token, dest, slot, gate_sorted, T_, row_block)
    xs = x.new_zeros((tables[0].shape[0], D_))
    xs[dest] = x[token]
    return x, wg, wu, scales, gs, tables, xs


@pytest.mark.parametrize("row_block", [8, 128])
def test_fused_gate_up_q8_plain_matches_sorted_on_scattered_buffer(row_block):
    """The plain #14 (rows gathered from x at tok_pad) equals the plain #10
    on the scattered (N_pad, D) buffer bit for bit (tolerance 0): both
    multiply the same rows of each expert, in the same order, by the same
    widened int8 weights, scale the fp32 sums and round once."""
    x, wg, wu, (sg, su), gs, (tok_pad, _, _, tg, tr, _), xs = _scattered_case(29 + row_block, row_block, True)
    h_fused = ref.fused_gate_up_q8_ref(x, wg, wu, sg, su, tok_pad, tg, tr, row_block)
    h_sorted = ref.grouped_gate_up_q8_ref(xs, wg, wu, sg, su, gs, row_block)
    assert h_fused.shape == h_sorted.shape == (tok_pad.shape[0], wg.shape[2])
    assert bool(h_sorted.float().abs().max() > 0)
    assert torch.equal(h_fused.view(torch.int16), h_sorted.view(torch.int16))


@pytest.mark.parametrize("row_block", [8, 128])
def test_fused_gate_up_plain_matches_sorted_on_scattered_buffer(row_block):
    """The plain #12 (rows gathered from x at tok_pad) equals the plain #3
    on the scattered (N_pad, D) buffer bit for bit (tolerance 0): both
    multiply the same rows of each expert, in the same order, by the same
    bf16 weights in fp32 and round once."""
    x, wg, wu, _, gs, (tok_pad, _, _, tg, tr, _), xs = _scattered_case(30 + row_block, row_block, False)
    h_fused = ref.fused_gate_up_ref(x, wg, wu, tok_pad, tg, tr, row_block)
    h_sorted = ref.grouped_gate_up_ref(xs, wg, wu, gs, row_block)
    assert h_fused.shape == h_sorted.shape == (tok_pad.shape[0], wg.shape[2])
    assert bool(h_sorted.float().abs().max() > 0)
    assert torch.equal(h_fused.view(torch.int16), h_sorted.view(torch.int16))
