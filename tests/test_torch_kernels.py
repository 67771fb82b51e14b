"""The port's GEMV and paged attention kernels on pools of q's dtype (the
KV-split kernel and the int8/int4 pools are in test_torch_split.py).

Here on the CPU: each plain PyTorch version against the JAX oracle in
`repro.kernels.ref` (f32, 1e-5) and, at one small shape, against the Pallas
kernel in interpret mode (1e-5; 3e-3 for LUT-exp attention, the JAX
package's own bound for the online LUT softmax), plus the launchers'
refusal of CPU tensors and of bad arguments; the float and fixed16 GEMVs'
plans (kernel choice, tiles, cluster) over every shape of the path, the
single-walk decode's cluster and window at any table width, and the page walk
that the decode kernel computes in LUT mode against the Pallas kernel in
interpret mode (1e-5). On the card (`-m gpu`): each CUDA kernel against its
plain version on the same inputs, the tensor-core GEMV at its ragged and
cluster shapes (and the RoPE models' LM heads of 151936 and 256000 rows)
and bit-identical across launches, the int8 and fixed16
GEMVs bit for bit at the shapes of `chip_smoke.py` on both routes, with
the fused fixed16 linear layer and the int8 LUT epilogue (their plain
versions are held to the JAX oracles in test_torch_quant.py), the int8
linear layer with x quantized in its load path bit for bit with its two
launches, and `quantize_int8_rows` bit for bit over every launch shape
of its plan, misaligned rows, f32 edge cases and every bf16 value.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import lut as tlut
from repro_torch.kernels import _build, gemv_pim, ops, paged_attention, paged_prefill

TBANK = tlut.LutBank.create(64)


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card, which has no JAX, can
    collect this file and run its `gpu` tests."""
    import jax
    import jax.numpy as jnp

    from repro.core import lut as jlut
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return SimpleNamespace(jax=jax, jnp=jnp, ops=jops, ref=jref,
                           bank=jlut.LutBank.create(64))


def _t(x, device="cpu"):
    return torch.from_numpy(np.array(x)).to(device)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Inputs, made with numpy from a seed
# ---------------------------------------------------------------------------

def _gemv_inputs(M, C, R, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(M, C) * 0.5).astype(np.float32)
    w = (rng.randn(R, C) * C ** -0.5).astype(np.float32)
    b = (rng.randn(R) * 0.5).astype(np.float32)
    return x, w, b


def quant_gemv_inputs(M, C, R, seed=0):
    """int8 and fixed16 GEMV operands at (M, C, R), made with numpy.

    int8: random payloads in [-127, 127] (row 0 of w at -127 throughout),
    positive f32 row scales and an f32 bias. fixed16: x in Q.10 and w in
    Q.12 of random values, with x row 0 at v = sqrt(5e8 / C) and w rows 0
    and 1 at +v and -v (sums of +-5e8, below 2^31, saturating both ways
    after a shift of 10 or 12) and w row 2 at 32767, whose sum with x row
    0 passes 2^31 and wraps."""
    rng = np.random.RandomState(seed)
    x8 = rng.randint(-127, 128, size=(M, C)).astype(np.int8)
    w8 = rng.randint(-127, 128, size=(R, C)).astype(np.int8)
    w8[0] = -127
    xs = (rng.rand(M) * 0.05 + 1e-3).astype(np.float32)
    ws = (rng.rand(R) * 0.01 + 1e-4).astype(np.float32)
    b = rng.randn(R).astype(np.float32)
    xq = np.clip(np.round(rng.randn(M, C) * 2 ** 10), -32768, 32767).astype(np.int16)
    wq = np.clip(np.round(rng.randn(R, C) * C ** -0.5 * 2 ** 12),
                 -32768, 32767).astype(np.int16)
    v = int(np.sqrt(5e8 / C))
    xq[0], wq[0], wq[1], wq[2] = v, v, -v, 32767
    return SimpleNamespace(x8=x8, w8=w8, xs=xs, ws=ws, b=b, xq=xq, wq=wq)


def fixed_linear_inputs(M, C, R, seed=0):
    """f32 operands of the fixed16 linear layer: `quant_gemv_inputs`' Q.10
    x and Q.12 w as values (x row 0 at v = sqrt(5e8 / C) / 2^10, w rows 0
    and 1 at +-v / 2^12: sums that saturate both ways after the shift),
    w row 2 at 8 (Q.12 saturates it to 32767; its sum with x row 0 passes
    2^31 and wraps), x's last row (M > 1) at 32 and w row 3 (R > 3) at -8,
    the extremes of both formats (a sum of -32767 * 32768 * C, which
    wraps), and a bias."""
    qi = quant_gemv_inputs(M, C, R, seed)
    x = qi.xq.astype(np.float32) / 2 ** 10
    w = qi.wq.astype(np.float32) / 2 ** 12
    w[2] = 8.0
    if M > 1:
        x[-1] = 32.0
    if R > 3:
        w[3] = -8.0
    return x, w, (qi.b * 0.5).astype(np.float32)


def _pool_inputs(B, H, Hkv, D, page, n_pages, lengths, Sq=None, seed=0):
    """Random pools behind shuffled block tables (trash page 0 included as
    the tail of short sequences' rows) and a query per row."""
    rng = np.random.RandomState(seed)
    P = 1 + B * n_pages
    phys = rng.permutation(np.arange(1, P)).reshape(B, n_pages).astype(np.int32)
    for b, ln in enumerate(lengths):
        phys[b, -(-max(ln, 1) // page):] = 0          # unmapped -> trash
    k = rng.randn(P, Hkv, page, D).astype(np.float32)
    v = rng.randn(P, Hkv, page, D).astype(np.float32)
    qshape = (B, H, D) if Sq is None else (B, Sq, H, D)
    q = rng.randn(*qshape).astype(np.float32)
    return q, k, v, phys, np.asarray(lengths, np.int32)


DECODE_CASES = [
    dict(B=3, H=4, Hkv=4, D=16, page=4, n_pages=5, lengths=[1, 9, 20]),
    dict(B=2, H=8, Hkv=2, D=32, page=8, n_pages=4, lengths=[17, 32]),
    dict(B=2, H=2, Hkv=1, D=10, page=4, n_pages=3, lengths=[5, 12]),   # scalar staging
]
DECODE_OPTS = [{}, {"lut": True}, {"window": 6}, {"softcap": 5.0},
               {"lut": True, "window": 5}]


def _attn_kw(opts, bank):
    kw = {k: v for k, v in opts.items() if k != "lut"}
    if opts.get("lut"):
        kw["exp_table"] = bank.exp
    return kw


# ---------------------------------------------------------------------------
# GEMV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,C,R", [(1, 64, 96), (3, 40, 37), (5, 128, 257)])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", [None, "gelu", "lut"])
def test_gemv_plain_matches_oracle(jx, M, C, R, bias, act):
    x, w, b = _gemv_inputs(M, C, R)
    b = b if bias else None
    jb = None if b is None else jx.jnp.asarray(b)
    want = jx.ref.gemv_pim_ref(jx.jnp.asarray(x), jx.jnp.asarray(w), jb,
                             act_table=jx.bank.gelu if act == "lut" else None)
    if act == "gelu":
        want = jx.jax.nn.gelu(want, approximate=True)
    got = gemv_pim.gemv_pim_plain(
        _t(x), _t(w), None if b is None else _t(b),
        act_table=TBANK.gelu if act == "lut" else None,
        act="gelu" if act == "gelu" else None)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("fused", [None, "lut"])
def test_gemv_plain_matches_pallas_interpret(jx, fused):
    x, w, b = _gemv_inputs(4, 512, 256, seed=1)
    want = jx.ops.pim_linear(jx.jnp.asarray(x), jx.jnp.asarray(w), jx.jnp.asarray(b),
                           act_table=jx.bank.gelu if fused else None,
                           impl="interpret")
    got = ops.pim_linear(_t(x), _t(w), _t(b),
                         act_table=TBANK.gelu if fused else None)
    _close(got, want, 1e-5)


# The GEMV shapes (R, C) of GPT-2 medium's path: q/k/v/o projections,
# w_up, w_down and the LM head.
PATH_SHAPES = [(1024, 1024), (4096, 1024), (1024, 4096), (50257, 1024)]


def _blocks(plan):
    return plan.row_tiles * plan.n_tiles * plan.cluster


def _k_range(plan, rank):
    """The K tiles [lo, hi) that cluster block `rank` sums, as the
    tensor-core kernel (csrc/gemv_pim.cu) splits them."""
    return (rank * plan.k_tiles // plan.cluster,
            (rank + 1) * plan.k_tiles // plan.cluster)


def _tile_writes(plan, M, R):
    """How many times the tensor-core kernel writes each output element
    (M, R), by its index arithmetic: block (row tile, token tile, rank)
    reduces elements [rank * E / cluster, (rank + 1) * E / cluster) of its
    (n_tile, 64) tile, E = n_tile * 64, token major, and writes element e
    at token n * n_tile + e // 64 and row t * 64 + e % 64 when both are
    inside (M, R)."""
    counts = torch.zeros(M * R, dtype=torch.int32)
    rows = torch.arange(plan.row_tiles)[:, None] * gemv_pim.TC_ROWS
    e_all = plan.n_tile * gemv_pim.TC_ROWS
    for n in range(plan.n_tiles):
        for rank in range(plan.cluster):
            e = torch.arange(rank * e_all // plan.cluster, (rank + 1) * e_all // plan.cluster)
            m = n * plan.n_tile + e // gemv_pim.TC_ROWS
            r = rows + (e % gemv_pim.TC_ROWS)[None, :]
            ok = (m[None, :] < M) & (r < R)
            idx = (m[None, :] * R + r)[ok]
            counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return counts.reshape(M, R)


@pytest.mark.parametrize("R,C", PATH_SHAPES)
def test_gemv_plan_covers_every_path_shape(R, C):
    """M = 1..512 on every weight of the path: the tensor-core kernel, a
    token tile no larger than the least that holds M (256 beyond), one
    64-row tile per 64 rows, and a cluster whose blocks split the K tiles
    with none lost, none twice and none empty; the grid is the largest of
    at most 132 blocks over every tile and cluster so allowed (ties to the
    larger tile), or, where every tile's grid exceeds 132, the least tile
    that holds M with no cluster."""
    for M in range(1, 513):
        plan = gemv_pim.gemv_plan(M, C, R, torch.bfloat16)
        fit = min(n for n in gemv_pim.TC_N if n >= min(M, 256))
        assert plan.route == "tensor_core"
        assert plan.n_tile in gemv_pim.TC_N and plan.n_tile <= fit
        assert plan.n_tiles == -(-M // plan.n_tile)
        assert plan.row_tiles == -(-R // gemv_pim.TC_ROWS)
        assert plan.k_tiles == -(-C // gemv_pim.TC_K)
        assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= plan.k_tiles
        ranges = [_k_range(plan, r) for r in range(plan.cluster)]
        assert ranges[0][0] == 0 and ranges[-1][1] == plan.k_tiles
        assert all(lo < hi for lo, hi in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert plan.cluster * plan.n_tile <= gemv_pim.TC_CLUSTER_TOKENS
        grids = {(n, cs): plan.row_tiles * -(-M // n) * cs
                 for n in gemv_pim.TC_N if n <= fit for cs in (1, 2, 4, 8)
                 if cs <= plan.k_tiles and cs * n <= gemv_pim.TC_CLUSTER_TOKENS}
        fitting = [g for g in grids.values() if g <= _build.SMS]
        if fitting:
            assert _blocks(plan) == max(fitting)
            assert plan.n_tile == max(n for (n, cs), g in grids.items() if g == max(fitting))
        else:
            assert (plan.n_tile, plan.cluster) == (fit, 1)


def test_gemv_plan_fills_the_card_at_decode():
    """At M = 4 the projections and w_down split C over 8 blocks (128 of
    them), w_up over 2 (128), and the LM head needs no cluster (786)."""
    got = {(R, C): (gemv_pim.gemv_plan(4, C, R, torch.bfloat16).cluster,
                    _blocks(gemv_pim.gemv_plan(4, C, R, torch.bfloat16)))
           for R, C in PATH_SHAPES}
    assert got == {(1024, 1024): (8, 128), (4096, 1024): (2, 128),
                   (1024, 4096): (8, 128), (50257, 1024): (1, 786)}


@pytest.mark.parametrize("dtype,C,aligned", [(torch.float32, 1024, True),
                                              (torch.bfloat16, 1001, True),
                                              (torch.bfloat16, 1020, True),
                                              (torch.bfloat16, 1024, False)])
def test_gemv_plan_routes_to_cuda_cores(dtype, C, aligned):
    """f32 operands, C % 8 != 0 (no 16-byte TMA stride) and unaligned rows
    take the CUDA-core kernel."""
    assert gemv_pim.gemv_plan(4, C, 1024, dtype, aligned=aligned).route == "cuda_core"


@pytest.mark.parametrize("M,C,R", [(1, 1024, 50257), (4, 1024, 1000), (9, 1024, 1024),
                                   (64, 4096, 1024), (65, 1024, 4096), (300, 1000, 1000),
                                   (512, 1024, 4096), (512, 4096, 1024)])
def test_gemv_tiles_write_every_output_once(M, C, R):
    """The kernel's index arithmetic writes each (m, r) of the output
    exactly once: ragged R and M edges masked, cluster slices disjoint."""
    plan = gemv_pim.gemv_plan(M, C, R, torch.bfloat16)
    assert torch.equal(_tile_writes(plan, M, R),
                       torch.ones((M, R), dtype=torch.int32))


# ---------------------------------------------------------------------------
# Paged decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("opts", DECODE_OPTS)
def test_paged_decode_plain_matches_oracle(jx, case, opts):
    q, k, v, tbl, lens = _pool_inputs(**case)
    want = jx.ref.paged_attention_ref(
        jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v), jx.jnp.asarray(tbl),
        jx.jnp.asarray(lens), **_attn_kw(opts, jx.bank))
    got = paged_attention.paged_attention_plain(
        _t(q), _t(k), _t(v), _t(tbl), _t(lens), **_attn_kw(opts, TBANK))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("lut", [False, True])
def test_paged_decode_plain_matches_pallas_interpret(jx, lut):
    q, k, v, tbl, lens = _pool_inputs(**DECODE_CASES[1], seed=3)
    want = jx.ops.pim_paged_attention(
        jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v), jx.jnp.asarray(tbl),
        jx.jnp.asarray(lens), exp_table=jx.bank.exp if lut else None,
        impl="interpret")
    got = ops.pim_paged_attention(_t(q), _t(k), _t(v), _t(tbl), _t(lens),
                                  exp_table=TBANK.exp if lut else None)
    _close(got, want, 3e-3 if lut else 1e-5)


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("opts", [{}, {"lut": True}, {"lut": True, "window": 5},
                                  {"softcap": 5.0}])
def test_online_walk_matches_pallas_interpret(jx, case, opts):
    """The page walk that the CUDA decode kernel is held to in LUT mode is
    the TPU kernel's own function: `paged_attention_online_plain` against
    the Pallas kernel in interpret mode, f32, within 1e-5 (exact and LUT)."""
    q, k, v, tbl, lens = _pool_inputs(**case, seed=7)
    want = jx.ops.pim_paged_attention(
        jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v), jx.jnp.asarray(tbl),
        jx.jnp.asarray(lens), impl="interpret", **_attn_kw(opts, jx.bank))
    got = paged_attention.paged_attention_online_plain(
        _t(q), _t(k), _t(v), _t(tbl), _t(lens), **_attn_kw(opts, TBANK))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("B,Hkv,n_pages,want", [(4, 16, 16, 4), (4, 16, 64, 4),
                                                (1, 16, 64, 8), (3, 2, 5, 4),
                                                (2, 2, 1, 1), (64, 16, 64, 1),
                                                (4, 8, 64, 8)])
def test_decode_cluster(B, Hkv, n_pages, want):
    """Blocks a (slot, kv head) at GPT-2's g = 1, head_dim 64, bf16 rows:
    doubled until the grid covers 132 SMs, at most 8 and at most one a
    page."""
    assert paged_attention.decode_plan(B, Hkv, n_pages, 1, 64, 16, 128)[0] == want


# (g, head_dim, K/V row bytes, the widest table in keys that 8 blocks held
# whole before runs were walked in windows): GPT-2 medium on bf16, int8
# and int4 pools; qwen2-1.5B's g = 6, head_dim 128 on bf16 pools; g = 12 x
# head_dim 192 (g * D past the old 1024 pairs) on bf16 pools.
DECODE_LIMITS = [(1, 64, 128, 101888), (1, 64, 64, 101888), (1, 64, 32, 101888),
                 (6, 128, 256, 30976), (12, 192, 384, 0)]


@pytest.mark.parametrize("g,D,row_bytes,keys", DECODE_LIMITS)
def test_decode_table_limit(g, D, row_bytes, keys):
    """The single walk has no width limit: one page past the old limit and
    qwen2-1.5B's 131072 keys are planned without a ValueError, each window
    within DECODE_SMEM_MAX. At 131072 keys the run no longer fits one
    block, so it is walked in windows of whole ring stages."""
    pa = paged_attention
    for n_pages in (keys // 16 + 1, 131072 // 16):
        cs, win = pa.decode_plan(1, 1, n_pages, g, D, 16, row_bytes)
        assert pa.decode_smem_bytes(g, D, 16, win, row_bytes, cs) <= pa.DECODE_SMEM_MAX
        run = -(-n_pages // cs)
        assert win >= run or win % pa.decode_chunk_pages(16, row_bytes, win) == 0
    assert cs == 8 and win < run


@pytest.mark.parametrize("B,n_pages,want", [(33, 64, 1), (33, 1024, 2), (33, 2048, 4),
                                            (33, 6368, 8)])
def test_decode_cluster_grows_to_fit_shared_memory(B, n_pages, want):
    """Once the grid covers the card (B x 16 kv heads >= 132), a run that
    would overflow one block's shared memory is spread over more blocks:
    GPT-2's 1024 keys fit one block, 16384 need two, 32768 four and
    101888 eight, in windows once a run outgrows one block."""
    cs, win = paged_attention.decode_plan(B, 16, n_pages, 1, 64, 16, 128)
    assert cs == want
    assert win == min(-(-n_pages // cs), paged_attention.decode_window_pages(1, 64, 16, 128, cs))
    assert paged_attention.decode_smem_bytes(1, 64, 16, win, 128, cs) <= 227 * 1024


# (M, C, R) -> (route, n_tile, cluster) of the int8 GEMV at the path's
# shapes: a decode step (M 4), a 64-token chunk, the LM head at M 1, and
# a C that no TMA stride takes (the __dp4a kernel).
INT8_PLANS = [((4, 1024, 1024), ("tensor_core", 8, 8)),
              ((4, 1024, 4096), ("tensor_core", 8, 2)),
              ((4, 4096, 1024), ("tensor_core", 8, 8)),
              ((1, 1024, 50257), ("tensor_core", 8, 1)),
              ((64, 1024, 1024), ("tensor_core", 32, 4)),
              ((64, 1024, 4096), ("tensor_core", 64, 2)),
              ((64, 4096, 1024), ("tensor_core", 32, 4)),
              ((4, 1000, 1024), ("cuda_core", 0, 1))]


@pytest.mark.parametrize("shape,want", INT8_PLANS)
def test_gemv_int8_plan(shape, want):
    """The int8 GEMV's route and tiling: s8 tensor cores in 128-element K
    tiles whenever C % 16 == 0, at most 132 blocks (the LM head's 786 row
    tiles take one block each), clusters splitting C."""
    M, C, R = shape
    plan = gemv_pim.gemv_int8_plan(M, C, R)
    assert (plan.route, plan.n_tile, plan.cluster) == want
    if plan.route == "tensor_core":
        assert plan.k_tiles == -(-C // 128)
        assert plan.row_tiles * plan.n_tiles * plan.cluster <= 132 or plan.cluster == 1
        assert plan.cluster <= plan.k_tiles
    assert gemv_pim.gemv_int8_plan(M, C, R, aligned=False).route == "cuda_core"


# (M, C, R) -> (route, n_tile, cluster) of the fixed16 GEMVs at the
# path's shapes: token tiles stop at 64 (three accumulator sets), K tiles
# of 128 elements, and a C that is not a multiple of 16 on the CUDA cores.
FIXED_PLANS = [((4, 1024, 1024), ("tensor_core", 8, 8)),
               ((4, 1024, 4096), ("tensor_core", 8, 2)),
               ((4, 4096, 1024), ("tensor_core", 8, 8)),
               ((1, 1024, 50257), ("tensor_core", 8, 1)),
               ((64, 1024, 4096), ("tensor_core", 64, 2)),
               ((512, 1024, 4096), ("tensor_core", 64, 1)),
               ((4, 1000, 1024), ("cuda_core", 0, 1)),
               ((4, 1032, 1024), ("cuda_core", 0, 1))]


@pytest.mark.parametrize("shape,want", FIXED_PLANS)
def test_gemv_fixed_plan(shape, want):
    """The fixed16 GEMVs' route and tiling: the 8-bit tensor cores whenever
    C % 16 == 0 and the rows are aligned, else the CUDA cores."""
    M, C, R = shape
    plan = gemv_pim.gemv_fixed_plan(M, C, R)
    assert (plan.route, plan.n_tile, plan.cluster) == want
    assert gemv_pim.gemv_fixed_plan(M, C, R, aligned=False).route == "cuda_core"


@pytest.mark.parametrize("R,C", PATH_SHAPES)
def test_gemv_fixed_plan_covers_every_path_shape(R, C):
    """M = 1..512 on every weight of the path: the tensor-core kernel with
    a token tile in TC_N_FIXED no larger than the least that holds M (64
    beyond), 128-element K tiles split over the cluster with none lost,
    none twice and none empty, and every output written exactly once."""
    for M in range(1, 513):
        plan = gemv_pim.gemv_fixed_plan(M, C, R)
        fit = min(n for n in gemv_pim.TC_N_FIXED if n >= min(M, 64))
        assert plan.route == "tensor_core"
        assert plan.n_tile in gemv_pim.TC_N_FIXED and plan.n_tile <= fit
        assert plan.n_tiles == -(-M // plan.n_tile)
        assert plan.row_tiles == -(-R // gemv_pim.TC_ROWS)
        assert plan.k_tiles == -(-C // gemv_pim.TC_K_INT8)
        assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= plan.k_tiles
        ranges = [_k_range(plan, r) for r in range(plan.cluster)]
        assert ranges[0][0] == 0 and ranges[-1][1] == plan.k_tiles
        assert all(lo < hi for lo, hi in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert _blocks(plan) <= _build.SMS or plan.cluster == 1
        if M in (1, 4, 64, 65, 512) and R < 50257:
            assert torch.equal(_tile_writes(plan, M, R), torch.ones((M, R), dtype=torch.int32))


# ---------------------------------------------------------------------------
# Paged prefill attention
# ---------------------------------------------------------------------------

PREFILL_CASES = [
    dict(B=2, H=4, Hkv=4, D=16, page=4, n_pages=5, Sq=6, starts=[0, 11]),
    dict(B=2, H=8, Hkv=2, D=32, page=8, n_pages=4, Sq=5, starts=[16, 3]),
    dict(B=1, H=2, Hkv=1, D=10, page=4, n_pages=4, Sq=5, starts=[7]),  # scalar staging
]


def _prefill_inputs(case, seed=0):
    c = dict(case)
    starts = np.asarray(c.pop("starts"), np.int32)
    lengths = starts + c["Sq"]
    q, k, v, tbl, lens = _pool_inputs(**c, lengths=list(lengths), seed=seed)
    return q, k, v, tbl, lens, starts


@pytest.mark.parametrize("case", PREFILL_CASES)
@pytest.mark.parametrize("opts", DECODE_OPTS)
def test_paged_prefill_plain_matches_oracle(jx, case, opts):
    q, k, v, tbl, lens, st = _prefill_inputs(case)
    want = jx.ref.paged_prefill_attention_ref(
        jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v), jx.jnp.asarray(tbl),
        jx.jnp.asarray(lens), jx.jnp.asarray(st), **_attn_kw(opts, jx.bank))
    got = paged_prefill.paged_prefill_attention_plain(
        _t(q), _t(k), _t(v), _t(tbl), _t(lens), _t(st), **_attn_kw(opts, TBANK))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("lut", [False, True])
def test_paged_prefill_plain_matches_pallas_interpret(jx, lut):
    q, k, v, tbl, lens, st = _prefill_inputs(PREFILL_CASES[1], seed=4)
    want = jx.ops.pim_paged_prefill_attention(
        jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v), jx.jnp.asarray(tbl),
        jx.jnp.asarray(lens), jx.jnp.asarray(st),
        exp_table=jx.bank.exp if lut else None, impl="interpret")
    got = ops.pim_paged_prefill_attention(
        _t(q), _t(k), _t(v), _t(tbl), _t(lens), _t(st),
        exp_table=TBANK.exp if lut else None)
    _close(got, want, 3e-3 if lut else 1e-5)


def test_one_query_chunk_is_a_decode_read():
    """A 1-token chunk at position length-1 is exactly a decode read."""
    q, k, v, tbl, lens = _pool_inputs(**DECODE_CASES[1], Sq=1)
    st = lens - 1
    got = paged_prefill.paged_prefill_attention_plain(
        _t(q), _t(k), _t(v), _t(tbl), _t(lens), _t(st))
    want = paged_attention.paged_attention_plain(
        _t(q[:, 0]), _t(k), _t(v), _t(tbl), _t(lens))
    _close(got[:, 0], want.numpy(), 1e-6)


# ---------------------------------------------------------------------------
# Launchers: no CPU fallback, unsupported inputs raise
# ---------------------------------------------------------------------------

def test_launchers_refuse_cpu_tensors():
    x, w, b = _gemv_inputs(2, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        gemv_pim.gemv_pim_float(_t(x), _t(w), _t(b))
    q, k, v, tbl, lens = _pool_inputs(**DECODE_CASES[0])
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.paged_attention(_t(q), _t(k), _t(v), _t(tbl), _t(lens))
    k8 = _t(np.clip(np.round(k * 20), -127, 127).astype(np.int8))
    with pytest.raises(ValueError, match="CUDA"):           # int8 pool, scale rows
        paged_attention.paged_attention(_t(q), k8, k8, _t(tbl), _t(lens),
                                        _t(k[..., 0]), _t(v[..., 0]))
    q4 = _t(q[:, None])
    with pytest.raises(ValueError, match="CUDA"):
        paged_prefill.paged_prefill_attention(q4, _t(k), _t(v), _t(tbl),
                                              _t(lens), _t(lens - 1))
    qi = quant_gemv_inputs(2, 32, 8)
    with pytest.raises(ValueError, match="CUDA"):
        gemv_pim.gemv_pim_int8(_t(qi.x8), _t(qi.xs), _t(qi.w8), _t(qi.ws), _t(qi.b))
    with pytest.raises(ValueError, match="CUDA"):
        gemv_pim.gemv_pim_fixed(_t(qi.xq), _t(qi.wq), shift=12)
    assert gemv_pim.gemv_pim_float.launches == 0
    assert gemv_pim.gemv_pim_int8.launches == 0
    assert gemv_pim.gemv_pim_fixed.launches == 0
    assert paged_attention.paged_attention.launches == 0
    assert paged_prefill.paged_prefill_attention.launches == 0


def test_quantized_launchers_refuse_bad_arguments():
    """Wrong dtypes, shapes, scale vectors, shifts and layouts raise before
    anything reaches the card."""
    qi = quant_gemv_inputs(2, 32, 8)
    x8, xs, w8, ws, b = (_t(a) for a in (qi.x8, qi.xs, qi.w8, qi.ws, qi.b))
    xq, wq = _t(qi.xq), _t(qi.wq)
    int8 = gemv_pim.gemv_pim_int8
    with pytest.raises(TypeError, match="int8 x and w"):
        int8(xq, xs, w8, ws)
    with pytest.raises(ValueError, match="need x"):
        int8(x8, xs, w8[:, :16], ws)
    with pytest.raises(ValueError, match="C >= 1"):
        int8(x8[:, :0], xs, w8[:, :0], ws)
    with pytest.raises(TypeError, match="x_scale must be torch.float32"):
        int8(x8, xs.double(), w8, ws)
    with pytest.raises(ValueError, match=r"w_scale must be \(8,\)"):
        int8(x8, xs, w8, ws[:4])
    with pytest.raises(ValueError, match=r"bias must be \(8,\)"):
        int8(x8, xs, w8, ws, b[:3])
    with pytest.raises(ValueError, match="w must be contiguous"):
        int8(x8, xs, w8.t().contiguous().t()[:, :32], ws)
    with pytest.raises(TypeError, match="int16 x and w"):
        gemv_pim.gemv_pim_fixed(xq, w8, shift=12)
    with pytest.raises(ValueError, match="shift"):
        gemv_pim.gemv_pim_fixed(xq, wq, shift=32)


def test_fused_quantized_launchers_refuse_bad_arguments():
    """The fixed16 linear launcher and the int8 GEMV's epilogue options
    raise on CPU tensors, mixed or integer dtypes, bad bias shapes, Q
    formats past 30 fraction bits and an integer output dtype, before
    anything reaches the card."""
    x, w, b = (_t(a) for a in fixed_linear_inputs(2, 32, 8))
    fn = gemv_pim.gemv_pim_fixed_linear
    kw = dict(frac_x=10, frac_w=12)
    with pytest.raises(ValueError, match="CUDA"):
        fn(x, w, b, **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16 x and w"):
        fn(x, w.to(torch.bfloat16), b, **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16 x and w"):
        fn(x.to(torch.int16), w.to(torch.int16), **kw)
    with pytest.raises(ValueError, match=r"bias must be \(8,\)"):
        fn(x, w, b[:5], **kw)
    with pytest.raises(ValueError, match="frac_w"):
        fn(x, w, b, frac_x=10, frac_w=31)
    qi = quant_gemv_inputs(2, 32, 8)
    x8, xs, w8, ws = (_t(a) for a in (qi.x8, qi.xs, qi.w8, qi.ws))
    with pytest.raises(TypeError, match="writes float32 or bfloat16"):
        gemv_pim.gemv_pim_int8(x8, xs, w8, ws, out_dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        gemv_pim.gemv_pim_int8(x8, xs.to(torch.bfloat16), w8, ws.to(torch.bfloat16),
                               out_dtype=torch.bfloat16, act_table=TBANK.gelu)
    assert fn.launches == 0 and gemv_pim.gemv_pim_int8.launches == 0


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m gpu` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M,C,R", [(4, 1024, 1024), (3, 1001, 777), (64, 256, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "gelu", "lut"])
def test_gemv_kernel_matches_plain(cuda, M, C, R, dtype, act):
    x, w, b = _gemv_inputs(M, C, R)
    x, w, b = (_t(a, cuda).to(dtype) for a in (x, w, b))
    kw = dict(act_table=TBANK.gelu if act == "lut" else None,
              act="gelu" if act == "gelu" else None)
    got = gemv_pim.gemv_pim_float(x, w, b, **kw)
    torch.cuda.synchronize()
    want = gemv_pim.gemv_pim_plain(x, w, b, **kw)
    _close(got, want.float().cpu().numpy(), 1e-4 if dtype == torch.float32 else 3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("opts", DECODE_OPTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_matches_plain(cuda, case, opts, dtype):
    q, k, v, tbl, lens = _pool_inputs(**case)
    q, k, v = (_t(a, cuda).to(dtype) for a in (q, k, v))
    tbl, lens = _t(tbl, cuda), _t(lens, cuda)
    kw = _attn_kw(opts, TBANK)
    got = paged_attention.paged_attention(q, k, v, tbl, lens, **kw)
    torch.cuda.synchronize()
    want = paged_attention.paged_attention_plain(q, k, v, tbl, lens, **kw)
    tol = 3e-2 if dtype == torch.bfloat16 else (3e-3 if opts.get("lut") else 1e-4)
    _close(got, want.float().cpu().numpy(), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("case", PREFILL_CASES)
@pytest.mark.parametrize("opts", DECODE_OPTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_prefill_kernel_matches_plain(cuda, case, opts, dtype):
    q, k, v, tbl, lens, st = _prefill_inputs(case)
    q, k, v = (_t(a, cuda).to(dtype) for a in (q, k, v))
    tbl, lens, st = _t(tbl, cuda), _t(lens, cuda), _t(st, cuda)
    kw = _attn_kw(opts, TBANK)
    got = paged_prefill.paged_prefill_attention(q, k, v, tbl, lens, st, **kw)
    torch.cuda.synchronize()
    want = paged_prefill.paged_prefill_attention_plain(q, k, v, tbl, lens, st, **kw)
    tol = 3e-2 if dtype == torch.bfloat16 else (3e-3 if opts.get("lut") else 1e-4)
    _close(got, want.float().cpu().numpy(), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 8, 9, 64, 65, 512])
@pytest.mark.parametrize("R,C", [(1000, 1024), (1024, 4096), (4096, 1024), (50257, 1024)])
@pytest.mark.parametrize("act", [None, "gelu", "lut"])
def test_gemv_tensor_core_kernel_matches_plain(cuda, M, R, C, act):
    """bf16 through the tensor-core kernel (counted by tc_launches) at the
    ragged and cluster shapes of the path, bias on, within 3e-2."""
    x, w, b = _gemv_inputs(M, C, R, seed=M)
    x, w, b = (_t(a, cuda).to(torch.bfloat16) for a in (x, w, b))
    kw = dict(act_table=TBANK.gelu if act == "lut" else None,
              act="gelu" if act == "gelu" else None)
    before = gemv_pim.gemv_pim_float.tc_launches
    got = gemv_pim.gemv_pim_float(x, w, b, **kw)
    torch.cuda.synchronize()
    assert gemv_pim.gemv_pim_float.tc_launches == before + 1
    want = gemv_pim.gemv_pim_plain(x, w, b, **kw)
    _close(got, want.float().cpu().numpy(), 3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 64])
@pytest.mark.parametrize("R,C", [(151936, 1536), (256000, 2304), (8960, 1536),
                                 (1536, 8960), (960, 3840)])
@pytest.mark.parametrize("act", [None, "lut"])
def test_gemv_tensor_core_kernel_at_rope_model_shapes(cuda, M, R, C, act):
    """bf16 through the tensor-core kernel at the RoPE models' LM heads
    (qwen2-1.5B's 151936 rows, gemma2-2B's 256000, both ragged on the
    64-row tile), qwen2's w_up and w_down, and h2o-danube3-4B's k/v (C
    3840, 30 K tiles), bias on, within 3e-2. Inputs are drawn on the card
    from a seeded generator."""
    gen = torch.Generator(device=cuda).manual_seed(R + C + M)
    x = (torch.randn((M, C), generator=gen, device=cuda) * 0.5).bfloat16()
    w = (torch.randn((R, C), generator=gen, device=cuda) * C ** -0.5).bfloat16()
    b = (torch.randn((R,), generator=gen, device=cuda) * 0.5).bfloat16()
    kw = dict(act_table=TBANK.silu if act == "lut" else None)
    before = gemv_pim.gemv_pim_float.tc_launches
    got = gemv_pim.gemv_pim_float(x, w, b, **kw)
    torch.cuda.synchronize()
    assert gemv_pim.gemv_pim_float.tc_launches == before + 1
    want = gemv_pim.gemv_pim_plain(x, w, b, **kw)
    _close(got, want.float().cpu().numpy(), 3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("M,C,R", [(4, 4096, 1024), (64, 1024, 4096), (65, 4096, 1024)])
def test_gemv_tensor_core_kernel_is_deterministic(cuda, M, C, R):
    """The cluster's partials are summed in rank order: two launches give
    the same bits."""
    x, w, b = _gemv_inputs(M, C, R, seed=2)
    x, w, b = (_t(a, cuda).to(torch.bfloat16) for a in (x, w, b))
    assert gemv_pim.gemv_plan(M, C, R, torch.bfloat16).cluster > 1
    first = gemv_pim.gemv_pim_float(x, w, b, act="gelu")
    second = gemv_pim.gemv_pim_float(x, w, b, act="gelu")
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,C", [(torch.float32, 1024), (torch.bfloat16, 1001)])
def test_gemv_cuda_core_route(cuda, dtype, C):
    """f32 and C % 8 != 0 run the CUDA-core kernel, not the tensor cores."""
    x, w, b = _gemv_inputs(4, C, 1024)
    x, w, b = (_t(a, cuda).to(dtype) for a in (x, w, b))
    before = (gemv_pim.gemv_pim_float.launches, gemv_pim.gemv_pim_float.tc_launches)
    got = gemv_pim.gemv_pim_float(x, w, b)
    torch.cuda.synchronize()
    assert (gemv_pim.gemv_pim_float.launches, gemv_pim.gemv_pim_float.tc_launches) == (
        before[0] + 1, before[1])
    _close(got, gemv_pim.gemv_pim_plain(x, w, b).float().cpu().numpy(),
           1e-4 if dtype == torch.float32 else 3e-2)


# The shapes of chip_smoke.py's kernel phase: decode (M = 1, 4) and chunk
# (M = 64) widths of GPT-2 medium's projections, FFN and LM head.
QUANT_SHAPES = [(1024, 1024), (4096, 1024), (1024, 4096), (50257, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 64])
@pytest.mark.parametrize("R,C", QUANT_SHAPES + [(777, 1001)])
@pytest.mark.parametrize("bias", [False, True])
def test_gemv_int8_kernel_matches_plain(cuda, M, R, C, bias):
    """Bit for bit: the same int32 sums and the same f32 roundings."""
    qi = quant_gemv_inputs(M, C, R)
    x8, xs, w8, ws, b = (_t(a, cuda) for a in (qi.x8, qi.xs, qi.w8, qi.ws, qi.b))
    b = b if bias else None
    got = gemv_pim.gemv_pim_int8(x8, xs, w8, ws, b)
    torch.cuda.synchronize()
    want = gemv_pim.gemv_pim_int8_plain(x8, xs, w8, ws, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 64])
@pytest.mark.parametrize("R,C", QUANT_SHAPES + [(777, 1001)])
@pytest.mark.parametrize("shift", [10, 12])
def test_gemv_fixed_kernel_matches_plain(cuda, M, R, C, shift):
    """Bit for bit, with rows that saturate both ways and one whose int32
    sum wraps."""
    qi = quant_gemv_inputs(M, C, R)
    xq, wq = _t(qi.xq, cuda), _t(qi.wq, cuda)
    got = gemv_pim.gemv_pim_fixed(xq, wq, shift=shift)
    torch.cuda.synchronize()
    want = gemv_pim.gemv_pim_fixed_plain(xq, wq, shift=shift)
    assert got.dtype == torch.int16
    assert torch.equal(got, want)
    assert int(want[0, 0]) == 32767 and int(want[0, 1]) == -32768


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 8, 9, 64, 65, 512])
@pytest.mark.parametrize("R,C", [(1000, 1024), (1024, 4096), (4096, 1024), (50257, 1024),
                                 (1024, 1000)])
@pytest.mark.parametrize("bias", [False, True])
def test_gemv_int8_routes_bit_for_bit(cuda, M, R, C, bias):
    """The s8 tensor-core kernel (counted by tc_launches) wherever C % 16
    == 0, the __dp4a kernel at C = 1000; both bit for bit."""
    qi = quant_gemv_inputs(M, C, R, seed=M)
    x8, xs, w8, ws, b = (_t(a, cuda) for a in (qi.x8, qi.xs, qi.w8, qi.ws, qi.b))
    b = b if bias else None
    before = gemv_pim.gemv_pim_int8.tc_launches
    got = gemv_pim.gemv_pim_int8(x8, xs, w8, ws, b)
    torch.cuda.synchronize()
    assert gemv_pim.gemv_pim_int8.tc_launches == before + (C % 16 == 0)
    assert torch.equal(got, gemv_pim.gemv_pim_int8_plain(x8, xs, w8, ws, b))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 8, 16, 64, 512])
@pytest.mark.parametrize("R,C", QUANT_SHAPES + [(1024, 1000)])
@pytest.mark.parametrize("shift", [10, 12])
def test_gemv_fixed_routes_bit_for_bit(cuda, M, R, C, shift):
    """The int16 kernel on the 8-bit tensor cores (counted by tc_launches)
    wherever C % 16 == 0, on the CUDA cores at C = 1000; both bit for bit,
    with rows that saturate both ways and one whose sum wraps."""
    qi = quant_gemv_inputs(M, C, R, seed=M)
    xq, wq = _t(qi.xq, cuda), _t(qi.wq, cuda)
    fn = gemv_pim.gemv_pim_fixed
    before = fn.tc_launches
    got = fn(xq, wq, shift=shift)
    torch.cuda.synchronize()
    assert fn.tc_launches == before + (C % 16 == 0)
    want = gemv_pim.gemv_pim_fixed_plain(xq, wq, shift=shift)
    assert torch.equal(got, want)
    assert int(want[0, 0]) == 32767 and int(want[0, 1]) == -32768


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 8, 16, 64, 512])
@pytest.mark.parametrize("R,C", QUANT_SHAPES + [(777, 1001), (1024, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epi", ["none", "bias", "bias+lut", "f32 bias+lut"])
def test_gemv_fixed_linear_routes_bit_for_bit(cuda, M, R, C, dtype, epi):
    """The fixed16 linear layer in one launch, x and w quantized as they
    load: on the 8-bit tensor cores wherever C % 16 == 0, else on the
    CUDA cores; bit for bit the plain composition, with sums that saturate
    both ways and sums that wrap past +-2^31, the bias in x's dtype or
    f32, and the LUT GELU on the cast value."""
    x, w, b = fixed_linear_inputs(M, C, R, seed=M)
    x, w = (_t(a, cuda).to(dtype) for a in (x, w))
    b = None if epi == "none" else _t(b, cuda).to(torch.float32 if "f32" in epi else dtype)
    kw = dict(frac_x=10, frac_w=12, act_table=TBANK.gelu if "lut" in epi else None)
    fn = gemv_pim.gemv_pim_fixed_linear
    before = (fn.launches, fn.tc_launches)
    got = fn(x, w, b, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tc_launches) == (before[0] + 1, before[1] + (C % 16 == 0))
    want = gemv_pim.gemv_pim_fixed_linear_plain(x, w, b, **kw)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int16, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2])
def test_gemv_fixed_misaligned_rows(cuda, dtype, offset):
    """x starting `offset` elements past a 16-byte boundary: the CUDA-core
    route (no TMA), bit for bit."""
    M, C, R = 4, 1024, 1024
    xf, wf, b = fixed_linear_inputs(M, C, R)
    qi = quant_gemv_inputs(M, C, R)
    x0 = _t(qi.xq if dtype == torch.int16 else xf, cuda).to(dtype)
    w = _t(qi.wq if dtype == torch.int16 else wf, cuda).to(dtype)
    buf = torch.zeros(M * C + 8, dtype=dtype, device=cuda)
    x = buf[offset:offset + M * C].view(M, C)
    x.copy_(x0)
    assert x.data_ptr() % 16 != 0
    if dtype == torch.int16:
        fn, plain, args = gemv_pim.gemv_pim_fixed, gemv_pim.gemv_pim_fixed_plain, (x, w)
        kw = dict(shift=12)
    else:
        fn, plain = gemv_pim.gemv_pim_fixed_linear, gemv_pim.gemv_pim_fixed_linear_plain
        args, kw = (x, w, _t(b, cuda).to(dtype)), dict(frac_x=10, frac_w=12)
    before = (fn.launches, fn.tc_launches)
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tc_launches) == (before[0] + 1, before[1])
    assert torch.equal(got, plain(*args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("M,C,R", [(4, 4096, 1024), (16, 1024, 1024), (64, 1024, 4096),
                                   (512, 4096, 1024)])
def test_gemv_fixed_kernels_are_deterministic(cuda, M, C, R):
    """Both fixed16 kernels sum the cluster's partials in rank order: two
    launches give the same bits."""
    x, w, b = fixed_linear_inputs(M, C, R, seed=3)
    x, w, b = (_t(a, cuda).to(torch.bfloat16) for a in (x, w, b))
    kw = dict(frac_x=10, frac_w=12, act_table=TBANK.gelu)
    first = gemv_pim.gemv_pim_fixed_linear(x, w, b, **kw)
    second = gemv_pim.gemv_pim_fixed_linear(x, w, b, **kw)
    qi = quant_gemv_inputs(M, C, R, seed=3)
    xq, wq = _t(qi.xq, cuda), _t(qi.wq, cuda)
    third = gemv_pim.gemv_pim_fixed(xq, wq, shift=12)
    fourth = gemv_pim.gemv_pim_fixed(xq, wq, shift=12)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(third, fourth)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 64])
@pytest.mark.parametrize("R,C", [(1024, 1024), (4096, 1024), (50257, 1024), (777, 1001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lut", [False, True])
def test_gemv_int8_epilogue_bit_for_bit(cuda, M, R, C, dtype, lut):
    """The q3 route's epilogue on both routes: scales and bias in x's
    dtype, the output cast to x's dtype, the LUT GELU on the cast value."""
    qi = quant_gemv_inputs(M, C, R, seed=M)
    x8, w8 = _t(qi.x8, cuda), _t(qi.w8, cuda)
    xs, ws, b = (_t(a, cuda).to(dtype) for a in (qi.xs, qi.ws * 0.05, qi.b))
    kw = dict(out_dtype=dtype, act_table=TBANK.gelu if lut else None)
    got = gemv_pim.gemv_pim_int8(x8, xs, w8, ws, b, **kw)
    torch.cuda.synchronize()
    want = gemv_pim.gemv_pim_int8_plain(x8, xs, w8, ws, b, **kw)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def quantize_rows_input(rows, C, seed=0):
    """Rows for quantize_int8_rows: random ones at several scales, a row of
    zeros, a row whose absmax is 127 (scale 1) holding exact .5 ties, and
    a row holding a NaN."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, C).astype(np.float32) * rng.choice([1e-3, 0.5, 30.0], size=(rows, 1))
    x[1] = 0.0
    x[2] = np.resize(np.array([2.5, -2.5, 3.5, -0.5, 0.5, 126.5, 1.5, 127.0], np.float32), C)
    x[3, C // 2] = np.nan
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("rows,C", [(4, 1024), (64, 4096), (1024, 1024), (9, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_rows_bit_for_bit(cuda, rows, C, dtype):
    """One launch a call; payload and scale bit for bit the plain
    function's in x's dtype, zero rows and .5 ties included; a row holding
    a NaN gets a NaN scale and the plain function's payload."""
    x = _t(quantize_rows_input(rows, C), cuda).to(dtype)
    before = gemv_pim.quantize_int8_rows.launches
    q, scale = gemv_pim.quantize_int8_rows(x)
    torch.cuda.synchronize()
    assert gemv_pim.quantize_int8_rows.launches == before + 1
    want_q, want_scale = gemv_pim.quantize_int8_rows_plain(x)
    assert scale.dtype == dtype and bool(scale[3].isnan()) and bool(want_scale[3].isnan())
    keep = torch.arange(rows, device=cuda) != 3
    assert torch.equal(scale[keep], want_scale[keep])
    assert torch.equal(q, want_q)
    assert int(q[1].abs().max()) == 0 and q[2, :6].tolist() == [2, -2, 4, 0, 0, 126]


F32, BF16 = torch.float32, torch.bfloat16
# (x dtype, compute dtype) of the int8 row quantization: q3's x and the
# weights in their own dtype, q1's bf16 x in f32.
QUANT_MODES = [(F32, F32), (BF16, BF16), (BF16, F32)]


def _quantize_same(x, compute, rows_with_nan=(), static_input=False):
    """quantize_int8_rows on the card, one launch, against the plain
    function of x cast to `compute`: payload and scale bit for bit (a
    NaN row's scale NaN on both sides)."""
    before = gemv_pim.quantize_int8_rows.launches
    q, scale = gemv_pim.quantize_int8_rows(x, compute=compute, static_input=static_input)
    torch.cuda.synchronize()
    assert gemv_pim.quantize_int8_rows.launches == before + 1
    want_q, want_scale = gemv_pim.quantize_int8_rows_plain(x.to(compute))
    assert scale.dtype == compute and q.dtype == torch.int8
    keep = torch.ones(scale.shape[0], dtype=torch.bool, device=x.device)
    for r in rows_with_nan:
        assert bool(scale[r].isnan()) and bool(want_scale[r].isnan())
        keep[r] = False
    assert torch.equal(scale[keep], want_scale[keep])
    assert torch.equal(q, want_q)
    return q


@pytest.mark.gpu
@pytest.mark.parametrize("rows,C", [(1, 16), (4, 1000), (4, 4096), (1024, 1024),
                                    (1024, 4096), (20000, 1024), (5, 20000), (3, 50001)])
@pytest.mark.parametrize("dtype,compute", QUANT_MODES)
@pytest.mark.parametrize("static_input", [False, True])
def test_quantize_int8_rows_plans_bit_for_bit(cuda, rows, C, dtype, compute, static_input):
    """Every launch shape of `quant_plan` (a few rows spread over warps,
    many rows a warp each in a persistent grid, rows past 8 warps'
    registers streamed, ragged C element by element), in x's dtype and in
    f32 on bf16 x, reading x before or after the wait for the kernel
    before: zero rows, .5 ties and a NaN row included."""
    x = _t(quantize_rows_input(max(rows, 4), C), cuda).to(dtype)[:rows].contiguous()
    q = _quantize_same(x, compute, [3] if rows > 3 else [], static_input)
    if rows > 2:
        assert int(q[1].abs().max()) == 0 and q[2, :6].tolist() == [2, -2, 4, 0, 0, 126]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,C", [(4, 1024), (1024, 1024), (4, 1000), (4, 20000)])
@pytest.mark.parametrize("dtype,compute", QUANT_MODES)
def test_quantize_int8_rows_misaligned_start(cuda, rows, C, dtype, compute):
    """x starting one element past a 16-byte boundary: the kernel reads and
    writes element by element, with the same bits."""
    flat = _t(quantize_rows_input(rows, C).reshape(-1), cuda).to(dtype)
    buf = torch.empty(rows * C + 1, dtype=dtype, device=cuda)
    buf[1:] = flat
    x = buf[1:].view(rows, C)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    _quantize_same(x, compute, [3] if rows > 3 else [])


def _every_bf16(device):
    """Every finite bf16 value, as a (65280,) bf16 tensor (+-0 included)."""
    bits = torch.arange(0, 0x7F80, dtype=torch.int32, device=device)
    pos = bits.to(torch.int16).view(torch.bfloat16)
    return torch.cat([pos, -pos])


@pytest.mark.gpu
@pytest.mark.parametrize("compute", [BF16, F32])
def test_quantize_int8_rows_every_bf16_value(cuda, compute):
    """The quotient x * r corrected once by an FMA is the correctly rounded
    x / scale over the whole bf16 domain: a row for every non-negative
    finite bf16 absmax a (32640 rows), each holding every finite bf16
    value of magnitude <= a (0 elsewhere), quantized in bf16 (q3's x and
    weights) and in f32 (q1's x), bit for bit the plain function."""
    vals = _every_bf16(cuda)
    amax = vals[: 0x7F80]                      # 0 and every positive finite value
    for a in torch.split(amax, 2048):
        x = torch.where(vals.abs()[None, :] <= a[:, None], vals[None, :],
                        torch.zeros((), dtype=BF16, device=cuda))
        _quantize_same(x.contiguous(), compute)


@pytest.mark.gpu
def test_quantize_int8_rows_f32_edges(cuda):
    """f32 rows at the edges of the division: exact .5 ties at power-of-two
    scales, values a few ulps from +-(k + .5) s and from +-127 s, the 1e-8
    floor (absmax below, at and just above it, subnormal x), and random
    values over the whole exponent range."""
    rng = np.random.RandomState(11)
    C = 1024
    rows = []
    for e in (-30, -3, 0, 5, 40):               # scale 2^e exactly
        s = np.float32(2.0 ** e)
        k = rng.randint(-127, 127, size=C).astype(np.float64) + 0.5
        r = (k * s).astype(np.float32)
        r[0] = np.float32(127 * s)
        rows.append(r)
    for _ in range(24):                          # near ties, random scales
        a = np.float32(10.0 ** rng.uniform(-6, 6))
        s = np.float32(np.float32(a) / np.float32(127))
        k = rng.randint(-127, 127, size=C).astype(np.float64) + 0.5
        r = (k * np.float64(s)).astype(np.float32)
        r = np.nextafter(r, r * np.float32(rng.choice([-1, 1], size=C)) * 2)
        r[: C // 4] = np.nextafter(np.float32(a), np.float32(0)) * rng.choice([-1, 1], C // 4)
        r[0] = a
        rows.append(r.astype(np.float32))
    for a in (9e-9, 1e-8, np.nextafter(np.float32(1e-8), np.float32(1)), 1e-40):
        rows.append((rng.rand(C) * 2 - 1).astype(np.float32) * np.float32(a))
    rows.append(np.float32(10.0) ** rng.uniform(-45, 38, size=C).astype(np.float32)
                * rng.choice([-1, 1], C).astype(np.float32))
    x = torch.from_numpy(np.stack(rows).astype(np.float32)).to(cuda)
    _quantize_same(x, F32)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 8, 64])
@pytest.mark.parametrize("C", [16, 1024, 4096, 8960])
@pytest.mark.parametrize("dtype,compute", QUANT_MODES)
@pytest.mark.parametrize("epi", ["none", "bias", "bias+lut"])
def test_gemv_int8_linear_bit_for_bit(cuda, M, C, dtype, compute, epi):
    """The int8 linear layer in one launch (x quantized in the kernel's
    load path, on a cluster or one block; at C 8960 and M 4 or 8 a block's
    share past the 4 pieces a thread held in registers; at M = 64 its two
    launches) is
    bit for bit `quantize_int8_rows` then `gemv_pim_int8` on
    the card, and the plain version: 1000 rows of w (a ragged row tile), a
    zero row of x, q3's bf16 scales and bias or q1's f32 scales."""
    rng = np.random.RandomState(M + C)
    x = _t((rng.randn(M, C) * 1.5).astype(np.float32), cuda).to(dtype)
    x[0, :] = 0 if M > 1 else x[0, :]
    w = _t((rng.randn(1000, C) * C ** -0.5).astype(np.float32), cuda).to(dtype)
    w8, ws = gemv_pim.quantize_int8_rows_plain(w.to(compute))
    b = _t((rng.randn(1000) * 0.5).astype(np.float32), cuda).to(dtype) if epi != "none" else None
    kw = dict(act_table=TBANK.gelu if epi == "bias+lut" else None)
    fn = gemv_pim.gemv_pim_int8_linear
    fused = gemv_pim.gemv_int8_linear_plan(M, C, 1000) is not None
    assert fused == (M < 64)
    before = (fn.launches, gemv_pim.quantize_int8_rows.launches, gemv_pim.gemv_pim_int8.launches)
    got = fn(x, w8, ws, b, compute=compute, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, gemv_pim.quantize_int8_rows.launches,
            gemv_pim.gemv_pim_int8.launches) == ((before[0] + 1, before[1], before[2]) if fused
                                                 else (before[0], before[1] + 1, before[2] + 1))
    x8, xs = gemv_pim.quantize_int8_rows(x, compute=compute)
    want = gemv_pim.gemv_pim_int8(x8, xs, w8, ws, b, out_dtype=dtype, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(got, gemv_pim.gemv_pim_int8_linear_plain(x, w8, ws, b, compute=compute,
                                                                **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("M,C,aligned", [(65, 1024, True), (512, 1024, True),
                                         (4, 1000, True), (4, 1024, False)])
def test_gemv_int8_linear_two_launch_route(cuda, M, C, aligned):
    """Where no token tile holds M, C % 16 != 0 or a row is misaligned,
    `gemv_pim_int8_linear` quantizes x by its own launch, then runs
    `gemv_pim_int8`, with the plain version's bits."""
    rng = np.random.RandomState(M)
    buf = _t((rng.randn(M * C + 1) * 1.5).astype(np.float32), cuda).to(BF16)
    x = (buf[:-1] if aligned else buf[1:]).view(M, C)
    w = _t((rng.randn(777, C) * C ** -0.5).astype(np.float32), cuda).to(BF16)
    w8, ws = gemv_pim.quantize_int8_rows_plain(w)
    before = (gemv_pim.gemv_pim_int8_linear.launches, gemv_pim.quantize_int8_rows.launches,
              gemv_pim.gemv_pim_int8.launches)
    got = gemv_pim.gemv_pim_int8_linear(x, w8, ws)
    torch.cuda.synchronize()
    assert (gemv_pim.gemv_pim_int8_linear.launches, gemv_pim.quantize_int8_rows.launches,
            gemv_pim.gemv_pim_int8.launches) == (before[0], before[1] + 1, before[2] + 1)
    assert torch.equal(got, gemv_pim.gemv_pim_int8_linear_plain(x, w8, ws))
