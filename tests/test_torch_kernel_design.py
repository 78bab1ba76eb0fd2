"""The numerical design of the tensor-core K1, K6 and K7, checked on the
CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them against
their plain versions there). What can be held here is the plan and the
arithmetic they carry out:

- the split of the long reduction axis fills the H100's 132 SMs at the
  shapes the main paths give each kernel, in ranges of whole k-tiles;
- K1's decomposition, bf16 products summed in fp32 per d_in split and per
  rank tile, the partials then summed in a fixed order, stays within
  1e-4 of max of the reference's Pallas kernel (interpret mode);
- K1's epilogue, those partials summed in index order, the Gram row sum
  split over a warp's 32 lanes and combined by an xor tree, then K2's
  assembly order, stays within 1e-6 of max |w_norm| of the reference's
  fused_norm (interpret mode), at a ragged d_out, ranks no multiple of
  32, with and without a cached base term, and propagates a NaN row;
- K7's hi/lo split of the fp32 operand t = gs⊙dY keeps d_h within 1e-5 of
  max |d_h| of the reference's Pallas kernel, with gs spanning 1e-3–1e1,
  where rounding t to bf16 alone lands near 1e-3;
- K6's persistent grid writes every [128 x 192] output tile exactly once
  and gives every SM work at the main paths' shapes; its arithmetic, bf16
  products summed in fp32 per 64-deep k-tile, then the compose in
  compose_elem's order rounded to bf16 once, stays within 2^-7 of max
  |delta| of the reference's Pallas kernel at ragged shapes; and the
  operands the autograd Function hands it on the main paths qualify for
  the tensor-core route;
- K9's grid of blocks x lanes holds every (batch, channel, state) once
  and masks the di edge; its arithmetic, exp as exp2 of dt times A
  pre-scaled by log2(e), per-lane partial sums of y over 16 / L states
  and the xor tree across the L lanes, stays within 1e-5 of max |y| and
  |h_f| of the reference's Pallas kernel and of the plain version.

The emulations below repeat the kernels' arithmetic in torch on the CPU;
they are not part of the package.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dora_compose as jk_compose
from repro.kernels import ops as jops
from repro.kernels.factored_norm import norm_terms_pallas
from repro.kernels.selective_scan import selective_scan_pallas
from repro_torch.kernels import _build
from repro_torch.kernels import dora_compose as tk_compose
from repro_torch.kernels import factored_norm as tk_norm
from repro_torch.kernels import norm_assembly as tk_assembly
from repro_torch.kernels import ops as tk_ops
from repro_torch.kernels import selective_scan as tk_scan

SMS = _build.SMS
BF16 = torch.bfloat16


@pytest.mark.parametrize("d_out,d_in", [
    (3584, 3584), (512, 3584), (18944, 3584), (3584, 18944),   # qwen2-7b
    (16384, 4096), (4096, 8192)])                 # falcon-mamba-7b in/out
def test_norm_terms_split_fills_the_card(d_out, d_in):
    r = 384
    splits, split_k = tk_norm.norm_terms_split(d_out, d_in, r)
    tiles = (_build.cdiv(d_out, tk_norm.TILE_ROWS)
             * _build.cdiv(r, tk_norm.TILE_RANK))
    assert split_k % tk_norm.TILE_K == 0
    assert splits == _build.cdiv(d_in, split_k)
    assert (splits - 1) * split_k < d_in <= splits * split_k
    assert tiles * splits >= SMS or split_k == tk_norm.TILE_K


@pytest.mark.parametrize("m,n", [(4096, 18944), (4096, 3584)])
def test_compose_mm_bwd_split_fills_the_card(m, n):
    r = 384
    splits, split_n = tk_compose.compose_mm_bwd_split(m, n, r)
    tiles = (_build.cdiv(m, tk_compose.MM_BWD_TILE_ROWS)
             * _build.cdiv(r, tk_compose.MM_BWD_TILE_RANK))
    assert split_n % tk_compose.MM_BWD_TILE_K == 0
    assert splits == _build.cdiv(n, split_n) > 1
    assert tiles * splits >= SMS


def test_split_plan_avoids_a_ragged_second_wave():
    # Two full waves of whole-axis blocks beat four waves of halves.
    assert _build.split_plan(2 * SMS, 4096, 64) == (1, 4096)
    # 56 tiles: 3 splits (168 blocks) would leave a second wave of 36
    # blocks; 4 splits give two waves of 112.
    assert _build.split_plan(56, 3584, 64) == (4, 896)
    # One tile and a short axis: one k-tile a split, the last ragged.
    assert _build.split_plan(1, 72, 32) == (3, 32)


def _bf16_np(rng, shape, scale):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(x).to(BF16)


def _emulate_norm_terms(W, A, B):
    """K1's arithmetic: per d_in split and per rank tile, exact bf16
    products summed in fp32 (U never leaves the block) and folded with B;
    then the partials summed in (split, rank tile) order."""
    d_out, d_in = W.shape
    r = A.shape[0]
    splits, split_k = tk_norm.norm_terms_split(d_out, d_in, r)
    W32, A32, B32 = W.float(), A.float(), B.float()
    base = torch.zeros(d_out)
    cross = torch.zeros(d_out)
    for s in range(splits):
        ks = slice(s * split_k, min(d_in, (s + 1) * split_k))
        base = base + (W32[:, ks] * W32[:, ks]).sum(dim=1)
        for c0 in range(0, r, tk_norm.TILE_RANK):
            cs = slice(c0, min(r, c0 + tk_norm.TILE_RANK))
            U = W32[:, ks] @ A32[cs, ks].T
            cross = cross + (B32[:, cs] * U).sum(dim=1)
    return base, cross, splits


@pytest.mark.parametrize("d_out,d_in,r", [(256, 1024, 136), (384, 512, 64)])
def test_norm_terms_split_arithmetic_matches_pallas(d_out, d_in, r):
    rng = np.random.default_rng(d_in + r)
    W = _bf16_np(rng, (d_out, d_in), d_in ** -0.5)
    A = _bf16_np(rng, (r, d_in), d_in ** -0.5)
    B = _bf16_np(rng, (d_out, r), 0.1)
    base, cross, splits = _emulate_norm_terms(W, A, B)
    assert splits > 1
    # The Pallas kernel takes r padded to the sublane size (zeros).
    rp = -(-r // 8) * 8
    f32 = lambda t: t.float().numpy()
    jb, jc = norm_terms_pallas(
        jnp.asarray(f32(W), jnp.bfloat16),
        jnp.asarray(np.pad(f32(A), ((0, rp - r), (0, 0))), jnp.bfloat16),
        jnp.asarray(np.pad(f32(B), ((0, 0), (0, rp - r))), jnp.bfloat16),
        block_rows=128, block_k=128, interpret=True)
    for got, want in ((base, jb), (cross, jc)):
        want = np.asarray(want, np.float32)
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), err


def _emulate_gram_row_sum(BG, B):
    """The epilogue's ba_sq = Σ_l BG_jl·B_jl: lane l of a row's warp sums
    columns l, l + 32, ... in index order (each product rounded, then
    added); the xor tree of offsets 16, 8, 4, 2, 1 adds the lane sums,
    leaving every lane with the same bits."""
    lanes = tk_norm.GRAM_LANES
    d_out, r = BG.shape
    prod = BG * B.float()
    part = torch.zeros(d_out, lanes)
    for c0 in range(0, r, lanes):
        chunk = prod[:, c0:c0 + lanes]
        part[:, :chunk.shape[1]] = part[:, :chunk.shape[1]] + chunk
    idx = torch.arange(lanes)
    off = lanes // 2
    while off:
        part = part + part[:, idx ^ off]
        off //= 2
    assert ((part == part[:, :1]) | part.isnan()).all()
    return part[:, 0]


def _pad_rows(x, rows):
    return np.pad(x, ((0, rows - x.shape[0]),) + ((0, 0),) * (x.ndim - 1))


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("s", [0.5, 2.0])
@pytest.mark.parametrize("d_out,d_in,r", [(200, 512, 40), (256, 1024, 136)])
def test_norm_epilogue_arithmetic_matches_pallas(d_out, d_in, r, s, cached):
    """K1 → epilogue on the tensor-core route, emulated: the partials
    summed in index order, the lane-split Gram row sum, K2's order; a NaN
    in row 3 of W stays NaN in w_norm. The reference pads d_out to a
    multiple of 128 with zero rows, which perturb no other row."""
    rng = np.random.default_rng(d_out + r)
    W = _bf16_np(rng, (d_out, d_in), d_in ** -0.5)
    W[3, 5] = float("nan")
    A = _bf16_np(rng, (r, d_in), d_in ** -0.5)
    B = _bf16_np(rng, (d_out, r), 0.1)
    cache = None
    if cached:
        cache = ((W.double() ** 2).sum(dim=1) * 1.01).float()
        cache[3] = 1.0
    base, cross, splits = _emulate_norm_terms(W, A, B)
    assert splits > 1
    if cache is not None:
        base = cache
    A32 = A.float()
    ba_sq = _emulate_gram_row_sum(B.float() @ (A32 @ A32.T), B)
    got = tk_assembly.assemble_norm_plain(base, cross, ba_sq, s).numpy()
    rows = -(-d_out // 128) * 128
    f32 = lambda t: _pad_rows(t.float().numpy(), rows)
    want = jops.fused_norm(
        jnp.asarray(f32(W), jnp.bfloat16),
        jnp.asarray(A.float().numpy(), jnp.bfloat16),
        jnp.asarray(f32(B), jnp.bfloat16), s, block_rows=128, block_k=128,
        interpret=True,
        base_sq_cache=None if cache is None else jnp.asarray(f32(cache)))
    want = np.asarray(want, np.float32)[:d_out]
    nan = np.isnan(want)
    assert nan[3] and (np.isnan(got) == nan).all()
    scale = np.abs(want[~nan]).max()
    err = np.abs(got[~nan] - want[~nan]).max()
    assert err <= 1e-6 * scale, err / scale


def _emulate_compose_mm_bwd(dy, B, gs, *, lo: bool = True):
    """K7's arithmetic for d_h: t = gs·dY rounded in fp32, hi = bf16(t),
    lo = bf16(t − hi), exact bf16 products of hi and lo with B summed in
    fp32 per N split, the splits summed in order."""
    m, n = dy.shape
    r = B.shape[1]
    splits, split_n = tk_compose.compose_mm_bwd_split(m, n, r)
    t = gs * dy.float()
    hi = t.to(BF16).float()
    lo_part = (t - hi).to(BF16).float()
    B32 = B.float()
    d_h = torch.zeros(m, r)
    for s in range(splits):
        ks = slice(s * split_n, min(n, (s + 1) * split_n))
        part = hi[:, ks] @ B32[ks]
        if lo:
            part = part + lo_part[:, ks] @ B32[ks]
        d_h = d_h + part
    return d_h, splits


@pytest.mark.parametrize("m,n,r", [(64, 1024, 64), (40, 512, 136)])
def test_compose_mm_bwd_hi_lo_matches_pallas(m, n, r):
    rng = np.random.default_rng(m + n)
    dy = _bf16_np(rng, (m, n), 1.0)
    B = _bf16_np(rng, (n, r), 0.1)
    # gs from 1e-3 to 1e1, log-uniform.
    gs = (10.0 ** rng.uniform(-3.0, 1.0, n)).astype(np.float32)
    gm1 = (0.05 * rng.standard_normal(n)).astype(np.float32)
    rp = -(-r // 128) * 128
    B_np = B.float().numpy()
    _, want = jk_compose.compose_mm_bwd_pallas(
        jnp.asarray(dy.float().numpy(), jnp.bfloat16),
        jnp.asarray(np.pad(B_np, ((0, 0), (0, rp - r))), jnp.bfloat16),
        jnp.asarray(gm1[None]), jnp.asarray(gs[None]), block_m=8,
        block_n=128, interpret=True)
    want = np.asarray(want, np.float32)[:, :r]
    scale = np.abs(want).max()
    got, splits = _emulate_compose_mm_bwd(dy, B, torch.from_numpy(gs))
    assert splits > 1
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * scale, err / scale
    hi_only, _ = _emulate_compose_mm_bwd(dy, B, torch.from_numpy(gs),
                                         lo=False)
    print(f"hi only: {np.abs(hi_only.numpy() - want).max() / scale:.3g} "
          f"of max |d_h|; hi + lo: {err / scale:.3g}")


# The main paths' K6 shapes: prefill and training rows on qwen2-7b's
# w_gate/w_up and wq/wo/w_down, falcon-mamba-7b's prefill rows on in_proj
# and out_proj.
MM_FWD_SHAPES = [(4096, 18944), (4096, 3584), (3840, 16384), (3840, 4096)]


@pytest.mark.parametrize("m,n", MM_FWD_SHAPES + [(200, 640), (5, 8)])
def test_compose_mm_fwd_schedule_writes_every_tile_once(m, n):
    """The kernel's walk, block b over tiles b, b + blocks, ...: each tile
    of the row-major tiling once, every block (one per SM where there are
    enough tiles) at least one."""
    rows = _build.cdiv(m, tk_compose.MM_FWD_TILE_ROWS)
    cols = _build.cdiv(n, tk_compose.MM_FWD_TILE_COLS)
    tiles = rows * cols
    blocks = tk_compose.compose_mm_fwd_blocks(m, n)
    assert blocks == min(SMS, tiles)
    seen = np.zeros((rows, cols), np.int64)
    for b in range(blocks):
        mine = range(b, tiles, blocks)
        assert len(mine) >= 1
        for t in mine:
            seen[t // cols, t % cols] += 1
    assert (seen == 1).all()
    if (m, n) in MM_FWD_SHAPES:
        assert blocks == SMS


def _emulate_compose_mm_fwd(base, h, B, gm1, s):
    """K6's tensor-core arithmetic: exact bf16 products summed in fp32 per
    64-deep k-tile, the k-tiles added in order; then t = s·lora and
    gm1·base + (gm1 + 1)·t in fp32 (no FMA), rounded to bf16 once."""
    r = h.shape[1]
    lora = torch.zeros(base.shape)
    for k0 in range(0, r, 64):
        ks = slice(k0, min(r, k0 + 64))
        lora = lora + h[:, ks].float() @ B[:, ks].float().T
    t = torch.tensor(s, dtype=torch.float32) * lora
    return (gm1 * base.float() + (gm1 + 1.0) * t).to(BF16)


@pytest.mark.parametrize("m,n,r", [(200, 640, 136), (130, 512, 384),
                                   (64, 384, 72)])
def test_compose_mm_fwd_mma_arithmetic_matches_pallas(m, n, r):
    """Ragged shapes: M no multiple of 128, N no multiple of 192 (but of
    the reference's 128 lanes), r = 136 ending inside a k-tile."""
    rng = np.random.default_rng(m + n + r)
    base = _bf16_np(rng, (m, n), 1.0)
    h = _bf16_np(rng, (m, r), 0.5)
    B = _bf16_np(rng, (n, r), 0.1)
    g = (1.0 + 0.05 * rng.standard_normal(n)).astype(np.float32)
    s = 1.25
    gm1 = torch.from_numpy(g) - 1.0
    got = _emulate_compose_mm_fwd(base, h, B, gm1, s)
    want = jops.fused_compose_mm(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (base, h, B)),
        jnp.asarray(g), s, mag_grad=False, block_m=64, block_n=128,
        interpret=True)
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2.0 ** -7 * np.abs(want).max(), err
    plain = tk_compose.compose_mm_fwd_plain(base, h, B, gm1, s)
    err = (got.float() - plain.float()).abs().max().item()
    assert err <= 2.0 ** -7 * plain.float().abs().max().item(), err


@pytest.mark.parametrize("n", [3584, 512, 18944, 16384, 4096])
def test_main_path_operands_qualify_for_the_mma_route(monkeypatch, n):
    """The operands the autograd Function builds for K6 (base and h from
    the layer's matmuls through ``_rows``, B one layer's slice of the
    stacked adapters, gm1 from g) at r = 384: bf16, 16-byte aligned, N
    and r multiples of 8."""
    r, d_in = 384, 64
    rng = np.random.default_rng(n)
    x = _bf16_np(rng, (2, 3, d_in), 1.0)
    A = _bf16_np(rng, (r, d_in), d_in ** -0.5)
    W = _bf16_np(rng, (n, d_in), d_in ** -0.5)
    B = _bf16_np(rng, (2, n, r), 0.02)[1]          # layer 1 of a stack
    g = torch.ones(n, dtype=torch.float32)
    seen = []

    def capture(base, h, B_, gm1, s):
        seen.append((base, h, B_, gm1, torch.empty_like(base)))
        return tk_compose.compose_mm_fwd_plain(base, h, B_, gm1, s)

    monkeypatch.setattr(tk_ops, "compose_mm_fwd", capture)
    tk_ops.fused_compose_mm(x @ W.T, x @ A.T, B, g, 2.0, mag_grad=False)
    (base, h, B_, gm1, out), = seen
    assert tuple(h.shape) == (6, r) and tuple(base.shape) == (6, n)
    assert _build.tensor_cores(base, h, B_, gm1, out, dims=(n, r))
    # What the route refuses: r not a multiple of 8, fp32 operands, an
    # operand off a 16-byte boundary.
    assert not _build.tensor_cores(base, h, B_, gm1, out, dims=(n, 36))
    assert not _build.tensor_cores(base.float(), h, B_, gm1, out,
                                   dims=(n, r))
    odd = torch.empty(base.numel() + 1, dtype=BF16)[1:].view(base.shape)
    assert not _build.tensor_cores(odd, h, B_, gm1, out, dims=(n, r))


SCAN_SHAPES = [(4, 960, 8192, 16), (1, 37, 8256, 16), (2, 64, 128, 4)]


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("b,s,di,n", SCAN_SHAPES)
def test_selective_scan_grid_holds_every_state_once(b, s, di, n, lanes):
    """At chip_smoke's K9 shapes, each lane count's grid gives every
    (batch row, channel, state) exactly one thread, the L lanes of a
    channel sit adjacent in one warp (so the xor masks below L stay in the
    channel), and only the last block along di has masked threads."""
    blocks, rows, channels = tk_scan.scan_schedule(b, di, lanes)
    assert rows == b and channels * lanes == tk_scan.SCAN_THREADS
    per_lane = tk_scan.MAX_STATE // lanes
    t = np.arange(tk_scan.SCAN_THREADS)
    d = np.arange(blocks)[:, None] * channels + t // lanes      # [x, t]
    first = np.broadcast_to((t % lanes) * per_lane, d.shape)
    live = d < di
    held = np.zeros((di, tk_scan.MAX_STATE), np.int64)
    for j in range(per_lane):
        np.add.at(held, (d[live], first[live] + j), 1)
    assert (held == 1).all()        # the same for each of the b rows
    assert live[:-1].all() and (blocks - 1) * channels < di
    assert (d[~live] >= di).all()
    for m in range(1, lanes):
        assert ((t ^ m) // lanes == t // lanes).all()
        assert ((t ^ m) // 32 == t // 32).all()


def _scan_case(seed, b, s, di, n):
    """dt log-uniform in [1e-3, 1e-1] (the Mamba init's range), dtx, B, C,
    A = -(1..n) with noise and h0, as numpy fp32 in the kernel's layout."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt = np.exp(np.log(1e-3) + rng.random((b, s, di)) * np.log(100.0))
    dt = dt.astype(np.float32)
    A_t = -(np.arange(1, n + 1, dtype=np.float32)[:, None]
            * (1.0 + 0.1 * rng.random((n, di)))).astype(np.float32)
    return (dt, (dt * f(b, s, di)).astype(np.float32), f(b, s, n),
            f(b, s, n), A_t, (0.5 * f(b, n, di)).astype(np.float32))


def _emulate_scan(dt, dtx, Bm, Cm, A_t, h0_t, lanes):
    """K9's arithmetic in fp32 torch: the states padded to 16 with zeros,
    exp(dt·A) as exp2(dt·A') with A' = A·log2(e) rounded once, each lane's
    partial sum of h·C over its 16 / L states in state order, then the
    lanes' partials summed pairwise, ((p0 + p1) + (p2 + p3))."""
    b, s, di = dt.shape
    n = A_t.shape[0]
    per_lane = tk_scan.MAX_STATE // lanes

    def pad(x, dim):
        shape = list(x.shape)
        shape[dim] = tk_scan.MAX_STATE - n
        return torch.cat([x, x.new_zeros(shape)], dim=dim)

    a2 = pad(A_t * np.float32(np.log2(np.e)), 0)            # [16, di]
    h, Bp, Cp = pad(h0_t, 1), pad(Bm, 2), pad(Cm, 2)
    ys = []
    for t in range(s):
        decay = torch.exp2(dt[:, t, None, :] * a2)
        h = decay * h + dtx[:, t, None, :] * Bp[:, t, :, None]
        prod = h * Cp[:, t, :, None]                        # [b, 16, di]
        parts = []
        for g in range(lanes):
            acc = torch.zeros(b, di)
            for j in range(per_lane):
                acc = acc + prod[:, g * per_lane + j]
            parts.append(acc)
        while len(parts) > 1:
            parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
        ys.append(parts[0])
    return torch.stack(ys, dim=1), h[:, :n]


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("ref,b,s,di,n", [
    ("pallas", 2, 64, 256, 16), ("pallas", 1, 32, 128, 4),
    ("plain", 1, 37, 130, 5)])                      # ragged S, n and di
def test_selective_scan_arithmetic_matches_pallas_and_plain(ref, b, s, di,
                                                            n, lanes):
    case = _scan_case(b * 100 + s + n, b, s, di, n)
    if ref == "pallas":     # S % chunk == 0 and di % block_di == 0
        want = selective_scan_pallas(*map(jnp.asarray, case), block_di=128,
                                     chunk=16, interpret=True)
    else:
        want = tk_scan.selective_scan_plain(*map(torch.from_numpy, case))
    got = _emulate_scan(*map(torch.from_numpy, case), lanes)
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (err, np.abs(w).max())
