"""Argument checks of the sorted int8 GEMM wrappers ``gate_up_q8_cuda``
(#10) and ``down_q8_cuda`` (#11): on the CPU, each wrong input or ``out=``
(dtype, shape, layout, device, or a base the kernel cannot read: off the
16-byte boundary that TMA needs, or a scale off the 4-byte boundary of its
bf16 pairs) raises ValueError before a library is loaded or a stream looked
up, and arguments the kernels take reach the library load. The kernels'
arithmetic is held against the JAX package in ``test_torch_quant.py``
(through their plain versions) and on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import expert_gemm as teg

E, N_PAD, D, F = 2, 256, 256, 128


def _misaligned(shape, dtype, by: int = 1):
    """A contiguous tensor whose data starts ``by`` elements past an aligned base."""
    n = int(np.prod(shape))
    return torch.zeros(n + by, dtype=dtype)[by:].view(shape)


def _tiles():
    return dict(tile_group=torch.zeros(N_PAD // 128, dtype=torch.int32),
                tile_rows=torch.full((N_PAD // 128,), 128, dtype=torch.int32))


def _gate_up_args(**faults):
    """#10's wrapper arguments at a small shape (E 2, N_pad 256, D 256, F
    128), each replaced by ``faults[name]`` where given."""
    args = dict(xs=torch.zeros((N_PAD, D), dtype=torch.bfloat16), w_gate=torch.zeros((E, D, F), dtype=torch.int8),
                w_up=torch.zeros((E, D, F), dtype=torch.int8), s_gate=torch.zeros((E, F), dtype=torch.bfloat16),
                s_up=torch.zeros((E, F), dtype=torch.bfloat16), **_tiles(), out=None)
    args.update(faults)
    return args


def _down_args(**faults):
    """#11's wrapper arguments at the same shape (h (256, 128), Wd (2, 128,
    256)), each replaced by ``faults[name]`` where given."""
    args = dict(h=torch.zeros((N_PAD, F), dtype=torch.bfloat16), w_down=torch.zeros((E, F, D), dtype=torch.int8),
                s_down=torch.zeros((E, D), dtype=torch.bfloat16), **_tiles(), out=None)
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

_GATE_UP_FAULTS = {
    ("xs", "shape"): torch.zeros((N_PAD, 2 * D), dtype=torch.bfloat16),
    ("xs", "rows"): torch.zeros((200, D), dtype=torch.bfloat16),
    ("xs", "rank"): torch.zeros((1, N_PAD, D), dtype=torch.bfloat16),
    ("xs", "dtype"): torch.zeros((N_PAD, D)),
    ("xs", "layout"): torch.zeros((N_PAD, 2 * D), dtype=torch.bfloat16)[:, ::2],
    ("xs", "device"): torch.zeros((N_PAD, D), dtype=torch.bfloat16, device="meta"),
    ("xs", "align"): _misaligned((N_PAD, D), torch.bfloat16),
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
    **_TILE_FAULTS,
    ("out", "shape"): torch.zeros((N_PAD, D), dtype=torch.bfloat16),
    ("out", "dtype"): torch.zeros((N_PAD, F)),
    ("out", "layout"): torch.zeros((N_PAD, 2 * F), dtype=torch.bfloat16)[:, ::2],
    ("out", "device"): torch.zeros((N_PAD, F), dtype=torch.bfloat16, device="meta"),
    ("out", "align"): _misaligned((N_PAD, F), torch.bfloat16),
}

_DOWN_FAULTS = {
    ("h", "shape"): torch.zeros((N_PAD, 2 * F), dtype=torch.bfloat16),
    ("h", "rows"): torch.zeros((200, F), dtype=torch.bfloat16),
    ("h", "dtype"): torch.zeros((N_PAD, F)),
    ("h", "layout"): torch.zeros((N_PAD, 2 * F), dtype=torch.bfloat16)[:, ::2],
    ("h", "device"): torch.zeros((N_PAD, F), dtype=torch.bfloat16, device="meta"),
    ("h", "align"): _misaligned((N_PAD, F), torch.bfloat16),
    ("w_down", "shape"): torch.zeros((E, 2 * F, D), dtype=torch.int8),
    ("w_down", "width"): dict(w_down=torch.zeros((E, F, 192), dtype=torch.int8),
                              s_down=torch.zeros((E, 192), dtype=torch.bfloat16)),
    ("w_down", "rank"): torch.zeros((F, D), dtype=torch.int8),
    ("w_down", "dtype"): torch.zeros((E, F, D), dtype=torch.bfloat16),
    ("w_down", "layout"): torch.zeros((E, F, 2 * D), dtype=torch.int8)[..., ::2],
    ("w_down", "device"): torch.zeros((E, F, D), dtype=torch.int8, device="meta"),
    ("w_down", "align"): _misaligned((E, F, D), torch.int8),
    ("s_down", "shape"): torch.zeros((E, F), dtype=torch.bfloat16),
    ("s_down", "dtype"): torch.zeros((E, D)),
    ("s_down", "layout"): torch.zeros((E, 2 * D), dtype=torch.bfloat16)[:, ::2],
    ("s_down", "device"): torch.zeros((E, D), dtype=torch.bfloat16, device="meta"),
    ("s_down", "align"): _misaligned((E, D), torch.bfloat16),
    **_TILE_FAULTS,
    ("out", "shape"): torch.zeros((N_PAD, F), dtype=torch.bfloat16),
    ("out", "dtype"): torch.zeros((N_PAD, D)),
    ("out", "layout"): torch.zeros((N_PAD, 2 * D), dtype=torch.bfloat16)[:, ::2],
    ("out", "device"): torch.zeros((N_PAD, D), dtype=torch.bfloat16, device="meta"),
    ("out", "align"): _misaligned((N_PAD, D), torch.bfloat16),
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
    return teg.gate_up_q8_cuda(a["xs"], a["w_gate"], a["w_up"], a["s_gate"], a["s_up"], a["tile_group"],
                               a["tile_rows"], out=a["out"])


def _down(a):
    return teg.down_q8_cuda(a["h"], a["w_down"], a["s_down"], a["tile_group"], a["tile_rows"], out=a["out"])


@pytest.mark.parametrize("arg,fault", sorted(_GATE_UP_FAULTS))
def test_gate_up_q8_args_checked_before_any_library(monkeypatch, arg, fault):
    """A wrong input or ``out=`` of #10's wrapper raises ValueError from the
    argument checks, before a library is loaded or a stream looked up."""
    _forbid_library(monkeypatch)
    with pytest.raises(ValueError, match="grouped_gate_up_q8"):
        _gate_up(_faulty(_gate_up_args, arg, _GATE_UP_FAULTS[(arg, fault)]))


@pytest.mark.parametrize("arg,fault", sorted(_DOWN_FAULTS))
def test_down_q8_args_checked_before_any_library(monkeypatch, arg, fault):
    """A wrong input or ``out=`` of #11's wrapper raises ValueError from the
    argument checks, before a library is loaded or a stream looked up."""
    _forbid_library(monkeypatch)
    with pytest.raises(ValueError, match="grouped_down_q8"):
        _down(_faulty(_down_args, arg, _DOWN_FAULTS[(arg, fault)]))


@pytest.mark.parametrize("out", [False, True])
@pytest.mark.parametrize("kernel", ["gate_up", "down"])
def test_sorted_q8_good_args_reach_the_library(monkeypatch, kernel, out):
    """Arguments the kernels take (with or without ``out=``) pass every
    check of #10's and #11's wrappers and reach the library load."""
    _forbid_library(monkeypatch, stream=False)
    if kernel == "gate_up":
        call, a = _gate_up, _gate_up_args(out=torch.zeros((N_PAD, F), dtype=torch.bfloat16) if out else None)
    else:
        call, a = _down, _down_args(out=torch.zeros((N_PAD, D), dtype=torch.bfloat16) if out else None)
    with pytest.raises(AssertionError, match="reached past"):
        call(a)
