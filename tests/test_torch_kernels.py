"""The port's kernel modules against the reference's Pallas kernels.

Each kernel's plain PyTorch version (what its wrapper runs on CPU tensors)
is held against the JAX package's Pallas kernel run in interpret mode, on
the same numpy inputs, in fp32 and bf16. Tolerances are scaled to the
reference's largest magnitude: 1e-5 of it where fp32 sums are taken in
another order (the matmul-based terms), 1e-6 where both sides run the
same pinned fp32 operations, and one bf16 ulp of it (2^-8) for bf16
outputs (2^-7 where an fp32 sum is rounded to bf16). The two autograd
Functions of ``kernels/ops.py`` are held against ``jax.grad`` through the
reference's custom-VJP wrappers in interpret mode. The CUDA kernels
themselves are held against the same plain versions on the card by
chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import dora_compose as jk_compose
from repro.kernels import ops as jops
from repro.kernels.factored_norm import norm_terms_pallas
from repro.kernels.paged_gather import paged_gather as j_paged_gather
from repro.kernels.paged_gather import paged_gather_ref as j_paged_ref
from repro.kernels.paged_gather import paged_scatter as j_paged_scatter
from repro.kernels.norm_assembly import assemble_norm_pallas
from repro_torch import kernels as tkernels
from repro_torch.bridge import tensor_from_numpy, tensor_to_numpy
from repro_torch.kernels import _build
from repro_torch.kernels import dora_compose as tk_compose
from repro_torch.kernels import factored_norm as tk_factored
from repro_torch.kernels import norm_assembly as tk_assembly
from repro_torch.kernels import ops as tops
from repro_torch.kernels.factored_norm import norm_terms
from repro_torch.kernels import paged_gather as tk_paged
from repro_torch.kernels.norm_assembly import (assemble_norm,
                                               assemble_norm_plain)

BF16 = ml_dtypes.bfloat16
DTYPES = {"fp32": (np.float32, 1e-5), "bf16": (BF16, 1e-5)}


def _np(rng, shape, dtype=np.float32, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32).astype(
        dtype)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    tol = rel * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, f"max err {err} > {tol} ({rel} x max|ref|)"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d_out,d_in,r", [(256, 384, 16), (128, 512, 40)])
def test_norm_terms_plain_matches_pallas(dtype, d_out, d_in, r):
    rng = np.random.default_rng(0)
    npdt, rel = DTYPES[dtype]
    W = _np(rng, (d_out, d_in), npdt, d_in ** -0.5)
    A = _np(rng, (r, d_in), npdt, d_in ** -0.5)
    B = _np(rng, (d_out, r), npdt, 0.1)
    # The Pallas kernel needs r padded to the sublane size; zeros are inert.
    rp = -(-r // 8) * 8
    Ap = np.pad(A, ((0, rp - r), (0, 0)))
    Bp = np.pad(B, ((0, 0), (0, rp - r)))
    jb, jc = norm_terms_pallas(jnp.asarray(W), jnp.asarray(Ap),
                               jnp.asarray(Bp), block_rows=128, block_k=128,
                               interpret=True)
    tb, tc = norm_terms(*(tensor_from_numpy(x) for x in (W, A, B)))
    _close(tb, jb, rel)
    _close(tc, jc, rel)
    assert tb.dtype == tc.dtype == torch.float32


@pytest.mark.parametrize("s", [0.5, 9.797958971132712])
def test_assemble_norm_plain_matches_pallas(s):
    rng = np.random.default_rng(1)
    n = 384
    base = np.abs(_np(rng, (n,)))
    cross = _np(rng, (n,), scale=0.1)
    ba = np.abs(_np(rng, (n,), scale=0.01))
    base[:5] = [np.nan, -1.0, 0.0, np.inf, 1.0]   # NaN, clamp, edges
    cross[1] = ba[1] = 0.0
    want = assemble_norm_pallas(*(jnp.asarray(v) for v in (base, cross, ba)),
                                s, interpret=True)
    got = assemble_norm(*(tensor_from_numpy(v) for v in (base, cross, ba)), s)
    got, want = _f32(got), _f32(want)
    assert np.isnan(got[0]) and np.isnan(want[0]), "max must propagate NaN"
    assert got[1] == want[1] == 0.0, "negative sums clamp to 0"
    assert np.isinf(got[3])
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    _close(got[fin], want[fin], 1e-6)


def test_assemble_norm_nan_propagates_through_plain():
    nan = torch.tensor([float("nan"), -2.0, 4.0])
    out = assemble_norm_plain(nan, torch.zeros(3), torch.zeros(3), 1.0)
    assert torch.isnan(out[0]) and out[1] == 0.0 and out[2] == 2.0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,n", [(8, 128), (100, 384), (3, 256)])
def test_compose_fwd_plain_matches_pallas(dtype, m, n):
    rng = np.random.default_rng(2)
    npdt, _ = DTYPES[dtype]
    base = _np(rng, (m, n), npdt)
    lora = _np(rng, (m, n), npdt, 0.5)
    g = (1.0 + 0.05 * rng.standard_normal(n)).astype(np.float32)
    s = 0.75
    # Through the wrappers: the reference pads the ragged rows to its
    # block, the port's kernel masks them.
    want = jops.fused_compose(jnp.asarray(base), jnp.asarray(lora),
                              jnp.asarray(g), s, save_inner=False,
                              mag_grad=False, block_m=64, block_n=128,
                              interpret=True)
    got = tops.fused_compose(tensor_from_numpy(base), tensor_from_numpy(lora),
                             tensor_from_numpy(g), s)
    assert got.dtype == tensor_from_numpy(base).dtype
    _close(got, want, 1e-6 if dtype == "fp32" else 2.0 ** -8)
    # ... and the bare kernel function on its own, on the first 8 rows
    # (the Pallas kernel takes whole 8-row blocks; pad with zero rows).
    rows = min(m, 8)
    b8 = np.pad(base[:rows], ((0, 8 - rows), (0, 0)))
    l8 = np.pad(lora[:rows], ((0, 8 - rows), (0, 0)))
    gm1 = (g - 1.0).reshape(1, n)
    want_k = jk_compose.compose_fwd_pallas(
        jnp.asarray(b8), jnp.asarray(l8), jnp.asarray(gm1), s,
        save_inner=False, block_m=8, block_n=128, interpret=True)
    got_k = tk_compose.compose_fwd(tensor_from_numpy(base[:rows]),
                                   tensor_from_numpy(lora[:rows]),
                                   tensor_from_numpy(gm1[0]), s)
    _close(got_k, _f32(want_k)[:rows],
           1e-6 if dtype == "fp32" else 2.0 ** -8)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,n,r", [(100, 256, 40), (64, 384, 16),
                                   (5, 128, 130)])
def test_compose_mm_fwd_plain_matches_pallas(dtype, m, n, r):
    """r not a multiple of 128 (the reference pads it, the port does not)
    and ragged rows."""
    rng = np.random.default_rng(3)
    npdt, rel = DTYPES[dtype]
    base = _np(rng, (m, n), npdt)
    h = _np(rng, (m, r), npdt, 0.5)
    B = _np(rng, (n, r), npdt, 0.1)
    g = (1.0 + 0.05 * rng.standard_normal(n)).astype(np.float32)
    s = 1.25
    want = jops.fused_compose_mm(jnp.asarray(base), jnp.asarray(h),
                                 jnp.asarray(B), jnp.asarray(g), s,
                                 mag_grad=False, block_m=64, block_n=128,
                                 interpret=True)
    got = tops.fused_compose_mm(*(tensor_from_numpy(x)
                                  for x in (base, h, B, g)), s)
    _close(got, want, rel if dtype == "fp32" else 2.0 ** -8)


def test_compose_mm_leading_dims_and_bad_shapes():
    rng = np.random.default_rng(4)
    base = torch.from_numpy(_np(rng, (2, 3, 128)))
    h = torch.from_numpy(_np(rng, (2, 3, 8)))
    B = torch.from_numpy(_np(rng, (128, 8)))
    g = torch.ones(128)
    out = tops.fused_compose_mm(base, h, B, g, 2.0)
    assert out.shape == base.shape
    # g == 1 → delta = s·(h·Bᵀ)
    torch.testing.assert_close(out, 2.0 * (h @ B.T), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="leading dims"):
        tops.fused_compose_mm(base, h[:1], B, g, 2.0)
    with pytest.raises(ValueError, match="do not agree"):
        tk_compose.compose_mm_fwd(base[0], h[0], B[:64], g, 2.0)
    with pytest.raises(ValueError, match="gm1"):
        tk_compose.compose_fwd(base[0], base[0], g[:64], 2.0)
    with pytest.raises(ValueError, match="do not agree"):
        norm_terms(B, h[0], B)


@pytest.mark.parametrize("s", [0.0, 1.5])
def test_fused_norm_matches_reference_wrapper(s):
    """s == 0 fast path and the cached base term, against the reference's
    fused_norm in interpret mode."""
    rng = np.random.default_rng(5)
    W = _np(rng, (256, 200), scale=0.07)
    A = _np(rng, (12, 200), scale=0.07)
    B = _np(rng, (256, 12), scale=0.1)
    want = jops.fused_norm(jnp.asarray(W), jnp.asarray(A), jnp.asarray(B),
                           s, block_rows=128, block_k=128, interpret=True)
    got = tops.fused_norm(*(tensor_from_numpy(x) for x in (W, A, B)), s)
    _close(got, want, 1e-5)
    base_sq = (W.astype(np.float64) ** 2).sum(1).astype(np.float32) * 1.01
    want_c = jops.fused_norm(jnp.asarray(W), jnp.asarray(A), jnp.asarray(B),
                             s, block_rows=128, block_k=128, interpret=True,
                             base_sq_cache=jnp.asarray(base_sq))
    got_c = tops.fused_norm(*(tensor_from_numpy(x) for x in (W, A, B)), s,
                            base_sq_cache=torch.from_numpy(base_sq))
    _close(got_c, want_c, 1e-5)
    assert not np.allclose(_f32(got_c), _f32(got))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,n", [(8, 128), (96, 384)])
def test_compose_fwd_dual_plain_matches_pallas(dtype, m, n):
    """K4: delta and inner = base + s·lora, as the reference's dual-output
    kernel writes them."""
    rng = np.random.default_rng(6)
    npdt, _ = DTYPES[dtype]
    base = _np(rng, (m, n), npdt)
    lora = _np(rng, (m, n), npdt, 0.5)
    gm1 = (0.05 * rng.standard_normal((1, n))).astype(np.float32)
    s = 1.75
    want_d, want_i = jk_compose.compose_fwd_pallas(
        jnp.asarray(base), jnp.asarray(lora), jnp.asarray(gm1), s,
        save_inner=True, block_m=8, block_n=128, interpret=True)
    got_d, got_i = tk_compose.compose_fwd_dual(
        tensor_from_numpy(base), tensor_from_numpy(lora),
        tensor_from_numpy(gm1[0]), s)
    assert got_d.dtype == got_i.dtype == tensor_from_numpy(base).dtype
    # Same pinned fp32 operations, one rounding to the output dtype.
    rel = 1e-6 if dtype == "fp32" else 2.0 ** -8
    _close(got_d, want_d, rel)
    _close(got_i, want_i, rel)
    # delta is K3's output, bit for bit.
    assert torch.equal(got_d, tk_compose.compose_fwd(
        tensor_from_numpy(base), tensor_from_numpy(lora),
        tensor_from_numpy(gm1[0]), s))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,n", [(8, 128), (64, 256)])
def test_compose_bwd_plain_matches_pallas(dtype, m, n):
    """K5: d_base = (g-1)⊙dY and d_lora = (g·s)⊙dY in dY's dtype."""
    rng = np.random.default_rng(7)
    npdt, _ = DTYPES[dtype]
    dy = _np(rng, (m, n), npdt)
    g = (1.0 + 0.05 * rng.standard_normal(n)).astype(np.float32)
    gm1, gs = (g - 1.0)[None], (g * np.float32(2.5))[None]
    want_b, want_l = jk_compose.compose_bwd_pallas(
        jnp.asarray(dy), jnp.asarray(gm1), jnp.asarray(gs), block_m=8,
        block_n=128, interpret=True)
    got_b, got_l = tk_compose.compose_bwd(tensor_from_numpy(dy),
                                          tensor_from_numpy(gm1[0]),
                                          tensor_from_numpy(gs[0]))
    assert got_b.dtype == got_l.dtype == tensor_from_numpy(dy).dtype
    rel = 1e-6 if dtype == "fp32" else 2.0 ** -8
    _close(got_b, want_b, rel)
    _close(got_l, want_l, rel)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,n,r", [(64, 256, 40), (8, 384, 130)])
def test_compose_mm_bwd_plain_matches_pallas(dtype, m, n, r):
    """K7: d_base and the fp32 d_h = ((g·s)⊙dY)·B summed over all of N;
    the reference's kernel takes the rank padded to 128 with zeros."""
    rng = np.random.default_rng(8)
    npdt, rel = DTYPES[dtype]
    dy = _np(rng, (m, n), npdt)
    B = _np(rng, (n, r), npdt, 0.1)
    g = (1.0 + 0.05 * rng.standard_normal(n)).astype(np.float32)
    gm1, gs = (g - 1.0)[None], (g * np.float32(0.8))[None]
    rp = -(-r // 128) * 128
    want_b, want_h = jk_compose.compose_mm_bwd_pallas(
        jnp.asarray(dy), jnp.asarray(np.pad(B, ((0, 0), (0, rp - r)))),
        jnp.asarray(gm1), jnp.asarray(gs), block_m=8, block_n=128,
        interpret=True)
    got_b, got_h = tk_compose.compose_mm_bwd(tensor_from_numpy(dy),
                                             tensor_from_numpy(B),
                                             tensor_from_numpy(gm1[0]),
                                             tensor_from_numpy(gs[0]))
    assert got_h.dtype == torch.float32 and got_h.shape == (m, r)
    _close(got_b, want_b, 1e-6 if dtype == "fp32" else 2.0 ** -8)
    # d_h: fp32 sums over N taken in another order.
    _close(got_h, _f32(want_h)[:, :r], rel)


def _grads(fn, *args):
    """Gradients of sum(fn(*args) ⊙ w) for a fixed numpy weight w."""
    out = fn(*args)
    w = np.random.default_rng(99).standard_normal(tuple(out.shape)).astype(
        np.float32)
    if isinstance(out, torch.Tensor):
        (out.float() * torch.from_numpy(w)).sum().backward()
        return [a.grad for a in args]
    return jax.grad(lambda *a: jnp.sum(fn(*a).astype(jnp.float32) * w),
                    argnums=tuple(range(len(args))))(*args)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("save_inner,mag_grad", [(True, True),
                                                 (False, True),
                                                 (False, False)])
def test_compose_function_grads_match_reference(dtype, save_inner, mag_grad):
    """The element-wise autograd Function (K4 or K3 forward, K5 backward,
    the separate d_g sum) against jax.grad through the reference's
    fused_compose in interpret mode. Leading dims and ragged rows."""
    rng = np.random.default_rng(9)
    npdt, _ = DTYPES[dtype]
    base = _np(rng, (3, 7, 256), npdt)
    lora = _np(rng, (3, 7, 256), npdt, 0.5)
    g = (1.0 + 0.05 * rng.standard_normal(256)).astype(np.float32)
    s = 1.5
    want = _grads(lambda b, lo, gg: jops.fused_compose(
        b, lo, gg, s, save_inner=save_inner, mag_grad=mag_grad, block_m=8,
        block_n=128, interpret=True), *map(jnp.asarray, (base, lora, g)))
    got = _grads(lambda b, lo, gg: tops.fused_compose(
        b, lo, gg, s, save_inner=save_inner, mag_grad=mag_grad),
        *(tensor_from_numpy(x).requires_grad_(True)
          for x in (base, lora, g)))
    for gt, wt in zip(got[:2], want[:2]):
        assert gt.dtype == tensor_from_numpy(base).dtype
        _close(gt, wt, 1e-6 if dtype == "fp32" else 2.0 ** -8)
    if mag_grad:
        _close(got[2], want[2], 1e-5)
    else:
        assert not got[2].any() and not np.asarray(want[2]).any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mag_grad", [True, False])
def test_compose_mm_function_grads_match_reference(dtype, mag_grad):
    """The matmul-fused autograd Function (K6 forward; K7 backward, then
    d_B and d_g from T = dYᵀ·h) against jax.grad through the reference's
    fused_compose_mm in interpret mode; r = 40 is not padded here."""
    rng = np.random.default_rng(10)
    npdt, rel = DTYPES[dtype]
    base = _np(rng, (2, 9, 256), npdt)
    h = _np(rng, (2, 9, 40), npdt, 0.5)
    B = _np(rng, (256, 40), npdt, 0.1)
    g = (1.0 + 0.05 * rng.standard_normal(256)).astype(np.float32)
    s = 0.9
    want = _grads(lambda b, hh, bb, gg: jops.fused_compose_mm(
        b, hh, bb, gg, s, mag_grad=mag_grad, block_m=8, block_n=128,
        interpret=True), *map(jnp.asarray, (base, h, B, g)))
    got = _grads(lambda b, hh, bb, gg: tops.fused_compose_mm(
        b, hh, bb, gg, s, mag_grad=mag_grad),
        *(tensor_from_numpy(x).requires_grad_(True)
          for x in (base, h, B, g)))
    _close(got[0], want[0], 1e-6 if dtype == "fp32" else 2.0 ** -8)
    # d_h and d_B are fp32 sums rounded to the input dtype at the end.
    for gt, wt in zip(got[1:3], want[1:3]):
        assert gt.dtype == tensor_from_numpy(h).dtype
        _close(gt, wt, rel if dtype == "fp32" else 2.0 ** -7)
    if mag_grad:
        _close(got[3], want[3], 1e-5)
    else:
        assert not got[3].any() and not np.asarray(want[3]).any()


def test_compose_wrappers_are_forward_only():
    """Forward-only where the tier says so: the wrappers carry gradients
    to base/lora (h, B) and g, but the Tier.FUSED_FWD call sites of the
    adapter detach g and take the plain K3 forward (no inner save)."""
    from repro_torch.core import adapter as tadapter
    from repro_torch.core.config import DoRAConfig

    base = torch.randn(4, 128, requires_grad=True)
    h = torch.randn(4, 8, requires_grad=True)
    B = torch.randn(128, 8, requires_grad=True)
    g = torch.full((128,), 1.1, requires_grad=True)
    tops.fused_compose(base, base, g, 1.0).sum().backward()
    assert base.grad is not None and g.grad is not None
    tops.fused_compose_mm(base, h, B, g, 1.0).sum().backward()
    assert h.grad is not None and B.grad is not None
    g.grad = None
    cfg = DoRAConfig(rank=8, mode="fused")
    tkernels.reset_launch_counts()
    for delta in (tadapter.compose_delta(base, base, g, cfg, training=False),
                  tadapter.compose_delta_factored(base, h, B, g, cfg,
                                                  training=False)):
        delta.sum().backward()
    assert g.grad is None, "Tier.FUSED_FWD must detach g"
    with torch.no_grad():
        assert tops.fused_compose_mm(base, h, B, g, 1.0).shape == (4, 128)


def test_plain_versions_do_not_count_launches():
    tkernels.reset_launch_counts()
    x = torch.ones(8, 128)
    tops.fused_compose(x, x, torch.ones(128), 1.0)
    tops.fused_norm(x, torch.ones(4, 128), torch.ones(8, 4), 1.0)
    assert tkernels.launch_counts() == dict.fromkeys(tkernels.KERNELS, 0)


def test_non_cpu_tensor_never_falls_back():
    """A tensor off the CPU launches the kernel or raises; here there is
    no card, so every wrapper raises instead of running its plain
    version."""
    meta = torch.empty(8, 128, device="meta")
    with pytest.raises(RuntimeError, match="CUDA unavailable"):
        tk_compose.compose_fwd(meta, meta, torch.empty(128, device="meta"),
                               1.0)
    with pytest.raises(RuntimeError, match="CUDA unavailable"):
        norm_terms(meta, torch.empty(4, 128, device="meta"),
                   torch.empty(8, 4, device="meta"))
    with pytest.raises(RuntimeError, match="CUDA unavailable"):
        v = torch.empty(8, device="meta")
        assemble_norm(v, v, v, 1.0)
    v = torch.empty(128, device="meta")
    for call in (lambda: tk_compose.compose_fwd_dual(meta, meta, v, 1.0),
                 lambda: tk_compose.compose_bwd(meta, v, v),
                 lambda: tk_compose.compose_mm_bwd(
                     meta, torch.empty(128, 4, device="meta"), v, v)):
        with pytest.raises(RuntimeError, match="CUDA unavailable"):
            call()


@pytest.mark.parametrize("cached", [False, True])
def test_fused_norm_on_cpu_runs_each_plain_version_once(monkeypatch, cached):
    """On CPU tensors the epilogue's path runs K1's plain version, the Gram
    row sum and K2's plain version, once each, gives the values of the
    two-wrapper chain (K1 terms, the Gram row sum, K2) and launches
    nothing."""
    rng = np.random.default_rng(9)
    W, A, B = (torch.from_numpy(_np(rng, shape, scale=0.1))
               for shape in ((200, 96), (12, 96), (200, 12)))
    s = 1.5
    base, cross = tk_factored.norm_terms_plain(W, A, B)
    cache = base * 1.01 if cached else None
    G = A @ A.T
    want = tk_assembly.assemble_norm_plain(
        base if cache is None else cache, cross, ((B @ G) * B).sum(dim=1), s)
    calls = {}
    for mod, name in ((tk_factored, "norm_terms_plain"),
                      (tk_assembly, "assemble_norm_plain")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    tkernels.reset_launch_counts()
    got = tops.fused_norm(W, A, B, s, base_sq_cache=cache)
    assert calls == {"norm_terms_plain": 1, "assemble_norm_plain": 1}
    assert torch.equal(got, want)
    assert tkernels.launch_counts() == dict.fromkeys(tkernels.KERNELS, 0)
    assert tk_factored.norm_terms.assembled_launches == 0


def test_norm_terms_assembly_never_falls_back():
    """K1 with its epilogue refuses a tensor off the CPU without a card
    like every wrapper, and refuses an assembly of the wrong shape."""
    meta = {name: torch.empty(shape, device="meta") for name, shape in
            (("W", (8, 128)), ("A", (4, 128)), ("B", (8, 4)),
             ("BG", (8, 4)), ("base_sq", (8,)))}
    W, A, B = meta["W"], meta["A"], meta["B"]
    for base_sq in (None, meta["base_sq"]):
        with pytest.raises(RuntimeError, match="CUDA unavailable"):
            norm_terms(W, A, B, tk_factored.Assembly(meta["BG"], 1.0,
                                                     base_sq))
    x = torch.ones(8, 128)
    with pytest.raises(ValueError, match="assembly"):
        norm_terms(x, torch.ones(4, 128), torch.ones(8, 4),
                   tk_factored.Assembly(torch.ones(8, 5), 1.0))
    with pytest.raises(ValueError, match="assembly"):
        norm_terms(x, torch.ones(4, 128), torch.ones(8, 4),
                   tk_factored.Assembly(torch.ones(8, 4), 1.0,
                                        torch.ones(7)))


def test_build_needs_nvcc_and_names_library_by_source_hash(monkeypatch,
                                                           tmp_path):
    assert _build.library_path().parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    assert _build.source_hash() in _build.library_path().name
    assert {p.name for p in _build.sources()} == {
        "norm_terms.cu", "assemble_norm.cu", "compose.cu", "compose_bwd.cu",
        "compose_mm.cu", "compose_mm_bwd.cu", "paged_gather.cu",
        "selective_scan.cu", "selective_scan_bwd.cu"}
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.probes, "nvcc_path", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert list(tmp_path.iterdir()) == []


def test_kernel_sources_name_the_tpu_kernel_they_replace():
    expect = {"norm_terms.cu": "factored_norm.py:49",
              "assemble_norm.cu": "norm_assembly.py:37",
              "compose.cu": "dora_compose.py:106",
              "compose_bwd.cu": "dora_compose.py:136",
              "compose_mm.cu": "dora_compose.py:211",
              "compose_mm_bwd.cu": "dora_compose.py:239",
              "paged_gather.cu": "paged_gather.py:90",
              "selective_scan.cu": "selective_scan.py:60",
              # no TPU kernel: the XLA scan the reference differentiates
              "selective_scan_bwd.cu": "models/mamba.py:50 _ssm_scan_fused"}
    for name, ref in expect.items():
        text = (_build.SRC_DIR / name).read_text()
        assert ref in text and "Bound on the H100" in text, name
    assert "--use_fast_math" not in " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def _paged_case(rng, dtype, n_blocks, bs, hkv, hd, b, mb):
    """A pool of random values and a table of distinct, out-of-order
    block ids with -1 holes (every third entry, and row 0's tail)."""
    pool = _np(rng, (n_blocks, bs, hkv, hd), dtype)
    ids = rng.permutation(n_blocks)[:b * mb].astype(np.int32)
    pages = ids.reshape(b, mb).copy()
    pages.reshape(-1)[::3] = -1
    pages[0, mb // 2:] = -1
    return pool, pages


def _bits(x):
    """Raw bits of a tensor or an array, for bitwise comparisons."""
    a = tensor_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n_blocks,bs,hkv,hd,b,mb",
                         [(12, 4, 1, 128, 2, 5), (20, 8, 2, 64, 3, 4)])
def test_paged_gather_plain_matches_pallas_bitwise(dtype, n_blocks, bs, hkv,
                                                   hd, b, mb):
    """K8's plain version (what the wrapper runs on CPU tensors) is a copy
    with a zero fill: bitwise the reference's Pallas kernel in interpret
    mode and its jnp reference, unallocated blocks reading as zeros."""
    rng = np.random.default_rng(b * mb)
    pool, pages = _paged_case(rng, DTYPES[dtype][0], n_blocks, bs, hkv, hd,
                              b, mb)
    tkernels.reset_launch_counts()
    got = tk_paged.paged_gather(tensor_from_numpy(pool),
                                tensor_from_numpy(pages))
    assert tkernels.launch_counts()["paged_gather"] == 0
    want = j_paged_gather(jnp.asarray(pool), jnp.asarray(pages),
                          interpret=True)
    ref = j_paged_ref(jnp.asarray(pool), jnp.asarray(pages))
    assert tuple(got.shape) == (b, mb * bs, hkv, hd)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    holes = np.repeat(pages < 0, bs, axis=1)
    assert not _f32(got)[holes].any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("all_holes", [False, True])
def test_paged_scatter_matches_reference_bitwise(dtype, all_holes):
    """The scatter writes the view back into the pool in place and drops
    the slices of -1 entries, bitwise as the reference's
    ``.at[].set(mode="drop")``, also when no entry is allocated."""
    rng = np.random.default_rng(7)
    n_blocks, bs, hkv, hd, b, mb = 16, 4, 2, 64, 3, 4
    pool, pages = _paged_case(rng, DTYPES[dtype][0], n_blocks, bs, hkv, hd,
                              b, mb)
    if all_holes:
        pages[...] = -1
    values = _np(rng, (b, mb * bs, hkv, hd), DTYPES[dtype][0])
    want = j_paged_scatter(jnp.asarray(pool), jnp.asarray(pages),
                           jnp.asarray(values))
    t_pool = tensor_from_numpy(pool.copy())
    out = tk_paged.paged_scatter(t_pool, tensor_from_numpy(pages),
                                 tensor_from_numpy(values))
    assert out is t_pool
    np.testing.assert_array_equal(_bits(t_pool), _bits(want))
    if all_holes:
        np.testing.assert_array_equal(_bits(t_pool), _bits(pool))


def test_paged_gather_then_scatter_round_trips():
    """Gathering a view and scattering it back leaves the pool as it was
    (the attention's read-modify-write, with nothing modified)."""
    rng = np.random.default_rng(3)
    pool, pages = _paged_case(rng, np.float32, 10, 4, 1, 128, 2, 4)
    t_pool, t_pages = tensor_from_numpy(pool.copy()), tensor_from_numpy(pages)
    view = tk_paged.paged_gather(t_pool, t_pages)
    tk_paged.paged_scatter(t_pool, t_pages, view)
    np.testing.assert_array_equal(t_pool.numpy(), pool)


def test_paged_gather_off_cpu_launches_or_raises():
    """A tensor off the CPU never runs the plain gather: here, with no
    card, the wrapper raises."""
    pool = torch.empty(4, 2, 1, 128, device="meta")
    pages = torch.empty(1, 2, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA unavailable"):
        tk_paged.paged_gather(pool, pages)
    with pytest.raises(ValueError, match="pool"):
        tk_paged.paged_gather(torch.zeros(4, 2, 128), torch.zeros(
            1, 2, dtype=torch.int32))


def test_launch_path_probes_each_card_once_and_keeps_every_check(
        monkeypatch):
    """The wrappers' shared host path: a probe that passes is run once per
    device index, a probe that fails runs (and raises) on every call and
    is never kept, and the operand checks still run on every call."""
    calls = []

    def passing(index=0):
        calls.append(index)
        return None

    monkeypatch.setattr(_build, "_probed", set())
    monkeypatch.setattr(_build.probes, "why_unavailable", passing)
    meta = torch.empty(8, 128, device="meta")
    for _ in range(4):
        _build.check_operands("k", meta, meta, dtype=torch.float32)
    _build.require_card(1)
    _build.require_card(1)
    assert calls == [0, 1]
    with pytest.raises(ValueError, match="operand 1 is not contiguous"):
        _build.check_operands("k", meta, meta.t())
    with pytest.raises(ValueError, match="operand 1 is on cpu"):
        _build.check_operands("k", meta, torch.empty(8, 128))
    with pytest.raises(TypeError, match="operand 1 has dtype"):
        _build.check_operands("k", meta, meta.to(torch.bfloat16),
                              dtype=torch.float32)
    assert calls == [0, 1]

    failed = []

    def failing(index=0):
        failed.append(index)
        return "no card in this test"

    monkeypatch.setattr(_build, "_probed", set())
    monkeypatch.setattr(_build.probes, "why_unavailable", failing)
    for _ in range(3):
        with pytest.raises(RuntimeError,
                           match="CUDA unavailable: no card in this test"):
            _build.check_operands("k", meta)
    with pytest.raises(RuntimeError, match="CUDA unavailable"):
        tk_paged.paged_gather(torch.empty(4, 2, 1, 128, device="meta"),
                              torch.empty(1, 2, dtype=torch.int32,
                                          device="meta"))
    assert failed == [0, 0, 0, 0] and _build._probed == set()
