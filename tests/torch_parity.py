"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py):
one config dict builds both packages' configs, JAX draws the parameters,
and ``params_from_numpy`` carries them to the port on the CPU.

Tolerances used across the files, with their reasons:

* ``FP32_ATOL = 1e-4`` — fp32 configs: both sides compute the same
  arithmetic; only the summation order of the matmuls differs.
* ``BF16_REL = 2e-2`` of max |ref| — bf16 inputs: the two frameworks round
  intermediates to bf16 at different points (a bf16 ulp is 2^-8 ~ 4e-3).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import ModelConfig as JModelConfig
from repro.config import MoEConfig as JMoEConfig
from repro_torch.config import ModelConfig as TModelConfig
from repro_torch.config import MoEConfig as TMoEConfig
from repro_torch.params import params_from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FP32_ATOL = 1e-4
BF16_REL = 2e-2

# tests/conftest.py:tiny_dense, plus a 4-expert top-2 MoE
TINY = dict(
    name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, vocab_divisor=64,
)
TINY_MOE = dict(num_experts=4, top_k=2, capacity_factor=None,
                router_type="mixtral", dispatcher="sorted")


def configs(moe: bool = True, fp32: bool = True, moe_kw=None, **kw):
    """(JAX config, port config) built from the same fields."""
    base = dict(TINY, **kw)
    if fp32:
        base["dtype"] = "float32"
    jm = tm = None
    if moe:
        mkw = dict(TINY_MOE, **(moe_kw or {}))
        base["family"] = "moe"
        jm, tm = JMoEConfig(**mkw), TMoEConfig(**mkw)
    return JModelConfig(**base, moe=jm), TModelConfig(**base, moe=tm)


def jax_params(jcfg, seed: int = 0, fp32: bool = True):
    """JAX parameters as tests/conftest.py:init_model draws them."""
    from repro.models.model import model_decl
    from repro.sharding.rules import init_from_decls

    params = init_from_decls(model_decl(jcfg), jax.random.PRNGKey(seed))
    if fp32:
        params = jax.tree.map(
            lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x, params
        )
    return params


def to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def f32(x) -> np.ndarray:
    """A JAX array or torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_rel(out, ref, rel=BF16_REL):
    out, ref = f32(out), f32(ref)
    err = float(np.max(np.abs(out - ref)))
    assert err <= rel * float(np.max(np.abs(ref))), (err, float(np.max(np.abs(ref))))



def _requires_grad(args) -> bool:
    return any(_requires_grad(a) if isinstance(a, (list, tuple)) else
               isinstance(a, torch.Tensor) and a.requires_grad for a in args)


class Float64(torch.overrides.TorchFunctionMode):
    """Evaluates the port's fp32 graph in fp64 for the gradient checks: in
    every torch call made inside the mode that reads a tensor requiring
    grad, ``.float()``, ``.to(float32)`` and ``dtype=float32`` become fp64.
    Calls that read no such tensor make the graph's constants (RoPE
    frequencies and angles, masks, positions): they run as written, in
    fp32, and their result is widened to fp64, so the fp64 graph computes
    the same function of the parameters as the fp32 programs do. Autograd's
    backward runs in the dtype of the saved tensors. Custom autograd
    Functions and non-reentrant checkpointing run outside the mode, so use
    it on the plain path with ``remat="none"``, parameters already fp64 and
    requiring grad.

    ``noise=seed`` multiplies every fp64 result by ``1 + 2**-24 * r``, r
    uniform in [-1, 1) from a generator seeded with ``seed``: the rounding
    of an fp32 evaluation, drawn independently of any implementation, so
    the spread of a few such draws measures how far fp32 rounding can move
    this graph's gradients."""

    def __init__(self, noise=None):
        super().__init__()
        self.gen = None if noise is None else torch.Generator().manual_seed(noise)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if not _requires_grad(list(args) + list(kwargs.values())):
            out = func(*args, **kwargs)
            return out.double() if isinstance(out, torch.Tensor) and out.dtype == torch.float32 else out
        name = getattr(func, "__name__", "")
        if name == "float":
            out = args[0].double()
        else:
            if kwargs.get("dtype") is torch.float32:
                kwargs["dtype"] = torch.float64
            if name == "to":
                args = tuple(torch.float64 if a is torch.float32 else a for a in args)
            out = func(*args, **kwargs)
        if self.gen is not None and isinstance(out, torch.Tensor) and out.dtype == torch.float64 \
                and not name.endswith("_"):
            with torch._C.DisableTorchFunction():
                r = torch.rand(out.shape, generator=self.gen, dtype=torch.float64) * 2 - 1
                out = out * (1 + 2.0 ** -24 * r)
        return out


def named(tree, prefix=""):
    """{path: leaf} of a nested dict, in either package's tree."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in named(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def check_grads(t, tp, tb, jm, jg, rel: float):
    """The port's ``loss_fn`` metrics on ``tb`` (kernel path) equal the JAX
    ones ``jm`` (1e-5 relative), and every parameter's gradient is within
    ``rel`` x max|g| of JAX's ``jg``, path by path."""
    from repro_torch.models.model import loss_fn

    leaves = named(tp)
    for x in leaves.values():
        x.requires_grad_(True)
    try:
        tloss, tm = loss_fn(t, tp, tb, use_kernel=True)
        tg = dict(zip(leaves, torch.autograd.grad(tloss, list(leaves.values()), allow_unused=True)))
    finally:
        for x in leaves.values():
            x.requires_grad_(False)
    for k in ("loss", "ce", "load_balance_loss", "z_loss"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-5, atol=1e-8, err_msg=k)
    ref_g = named(jg)
    assert sorted(ref_g) == sorted(tg)
    for name, ref in ref_g.items():
        ref, g = f32(ref), tg[name]
        scale = float(np.abs(ref).max())
        if not scale:
            assert g is None or not float(g.abs().max()), name
            continue
        err = float(np.abs(f32(g) - ref).max())
        assert err <= rel * scale, (name, err / scale, rel)


def check_grads_fp64(t, tp, tb, jm, jg, draws: int = 3):
    """As :func:`check_grads`, for graphs whose fp32 gradients rounding
    alone moves by percent: each leaf's gradients, the port's (kernel path)
    and JAX's ``jg``, are held against the port's graph evaluated in fp64
    (``Float64``, plain path, remat off), with e = max|g32 - g64| /
    max|g64| and ``noise`` the largest such e of ``draws`` fp64 evaluations
    perturbed at fp32's rounding size: e_port <= 1.5 (e_jax + noise) +
    1e-6, e_jax <= 10 noise + 1e-6 (``test_torch_train.py``'s rule). The
    loss metrics are held by the same rule."""
    from repro_torch.models.model import loss_fn
    from repro_torch.params import tree_map

    def grads(params, cfg, use_kernel, mode=None):
        leaves = named(params)
        for x in leaves.values():
            x.requires_grad_(True)
        try:
            with mode or contextlib.nullcontext():
                loss, met = loss_fn(cfg, params, tb, use_kernel=use_kernel)
            return met, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)))
        finally:
            for x in leaves.values():
                x.requires_grad_(False)

    tm, g32 = grads(tp, t, True)
    plain = t.replace(remat="none")
    m64, g64 = grads(tree_map(lambda x: x.double(), tp), plain, False, Float64())
    noisy = [grads(tree_map(lambda x: x.double(), tp), plain, False, Float64(noise=i)) for i in range(draws)]
    ref_g = named(jg)
    assert sorted(ref_g) == sorted(g32)
    pairs = [(k, float(tm[k].detach()), float(jm[k]), float(m64[k].detach()), [float(m[k].detach()) for m, _ in noisy])
             for k in ("loss", "ce", "load_balance_loss", "z_loss")]
    pairs += [(k, f32(g32[k]), f32(ref_g[k]), c.numpy(), [g[k].numpy() for _, g in noisy]) for k, c in g64.items()]
    for name, port, ref, c, draws_ in pairs:
        scale = np.abs(c).max()
        if not scale:
            continue
        n = max(np.abs(d - c).max() for d in draws_) / scale
        e_port, e_jax = np.abs(port - c).max() / scale, np.abs(ref - c).max() / scale
        assert e_port <= 1.5 * (e_jax + n) + 1e-6, (name, e_port, e_jax, n)
        assert e_jax <= 10 * n + 1e-6, (name, e_jax, n)
