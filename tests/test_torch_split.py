"""The KV-split decode path and the int8/int4 pool branches of the paged
attention kernels.

Here on the CPU, in f32 within 1e-5: the port's
`merge_partial_softmax_stacked` against the JAX one (the all-empty case
gives 0, not NaN); `paged_attention_split_plain` against
`ref.paged_attention_split_ref` at K in {2, 5, 7, n_pages} over fp, int8
(f32/bf16 scales) and int4 pools, exact and LUT, with softcap and window,
lengths 0 to full; the scale-row branches of the decode and prefill plain
versions against their oracles; the split plain version, reached through
`ops.pim_paged_attention`, against the Pallas split kernel in interpret
mode; and the launchers' argument checks. On the card (`-m gpu`): the
split kernel with its combine, the combine alone, and the decode and
prefill kernels on int8/int4 pools, each against its plain version (f32
exact 1e-4, f32 LUT 3e-3, bf16 3e-2), the split kernel against the
unsplit one, and the single-walk decode kernel at g = 2 over 1024 keys on
every pool format, LUT mode held to the page walk it computes, at the
limits of its shared memory (the widest table, and a cluster the table's
width sets), and forced into windows at a few hundred keys on every pool
format; the wide and windowed cases plant dominant keys so that their
outputs are O(1) and the tolerance binds; the decode and prefill
kernels at the RoPE models' heads (g x head_dim 6 x 128, 2 x 256 with a
softcap and a window, 4 x 120 with a window, 12 x 192) over 4800 keys on
every pool format.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import lut as tlut
from repro_torch.distributed.collectives import merge_partial_softmax_stacked
from repro_torch.kernels import ops, paged_attention, paged_prefill
from repro_torch.serving import quantize as tq

TBANK = tlut.LutBank.create(64)
POOLS = ["fp", "int8-f32", "int8-bf16", "int4"]
OPTS = [{}, {"lut": True}, {"softcap": 5.0, "window": 6}]


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card, which has no JAX, can
    collect this file and run its `gpu` tests."""
    import jax.numpy as jnp

    from repro.core import lut as jlut
    from repro.distributed import collectives as jcoll
    from repro.kernels import paged_attention as jpaged
    from repro.kernels import paged_prefill as jprefill
    from repro.kernels import ref as jref

    def arr(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.asarray(t.numpy())

    return SimpleNamespace(jnp=jnp, ref=jref, coll=jcoll, paged=jpaged, prefill=jprefill, arr=arr,
                           bank=jlut.LutBank.create(64))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _kw(opts, bank):
    kw = {k: v for k, v in opts.items() if k != "lut"}
    if opts.get("lut"):
        kw["exp_table"] = bank.exp
    return kw


def _plant_hot_keys(rng, q, k, v, phys, lengths, page, hot, target=18.0):
    """Give each decode row (q (B, H, D)) `hot` keys, one in each of `hot`
    equal stretches of its length at a random offset, whose scores stand
    near `target` (k = c q; the rest score about N(0, 1)) with V rows of
    std 4. The output is then a mix of those few V rows, O(1), so a walk
    that drops a run or a window of pages, or merges them wrongly, misses
    by O(1) rather than by the 1/sqrt(keys) of random inputs."""
    B, H, D = q.shape
    g = H // k.shape[1]
    for b, n in enumerate(lengths):
        for h in range(H):
            qh = q[b, h]
            for j in range(hot):
                pos = min(int((j + 0.1 + 0.8 * rng.rand()) / hot * n), n - 1)
                c = (target + rng.uniform(-1.5, 1.5)) * np.sqrt(D) / float(qh @ qh)
                at = (phys[b, pos // page], h // g, pos % page)
                k[at] = c * qh
                v[at] = 4.0 * rng.randn(D)


def _case(pool, B, H, Hkv, D, page, n_pages, lengths, Sq=None, seed=0,
          device="cpu", hot=0):
    """q, pools, scale rows (None for fp), shuffled block tables (trash page
    0 at the tail of short rows) and lengths, made with numpy from a seed;
    quantized pools go through the port's write-time quantization. hot > 0
    plants that many dominant keys a decode row (`_plant_hot_keys`)."""
    rng = np.random.RandomState(seed)
    P = 1 + B * n_pages
    phys = rng.permutation(np.arange(1, P)).reshape(B, n_pages).astype(np.int32)
    for b, ln in enumerate(lengths):
        phys[b, -(-max(ln, 1) // page):] = 0
    k = rng.randn(P, Hkv, page, D).astype(np.float32)
    v = rng.randn(P, Hkv, page, D).astype(np.float32)
    qshape = (B, H, D) if Sq is None else (B, Sq, H, D)
    q = rng.randn(*qshape).astype(np.float32)
    if hot:
        _plant_hot_keys(rng, q, k, v, phys, lengths, page, hot)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    ks = vs = None
    if pool != "fp":
        quant = tq.quantize_vec_int4 if pool == "int4" else tq.quantize_vec
        sd = torch.float32 if pool == "int8-f32" else torch.bfloat16
        (k, ks), (v, vs) = quant(k, sd), quant(v, sd)
    out = [q, k, v, ks, vs, torch.from_numpy(phys),
           torch.from_numpy(np.asarray(lengths, np.int32))]
    return [None if t is None else t.to(device) for t in out]


SMALL = dict(B=3, H=4, Hkv=2, D=16, page=4, n_pages=8, lengths=[0, 13, 32])


# ---------------------------------------------------------------------------
# The merge
# ---------------------------------------------------------------------------

def test_merge_matches_jax(jx):
    rng = np.random.RandomState(3)
    B, Hkv, K, g, D = 2, 2, 5, 2, 16
    m = rng.randn(B, Hkv, K, g, 1).astype(np.float32) * 3
    l = rng.rand(B, Hkv, K, g, 1).astype(np.float32) * 4 + 0.1
    acc = rng.randn(B, Hkv, K, g, D).astype(np.float32)
    empty = np.zeros((B, Hkv, K, g), bool)
    empty[0, 0, 1:3] = True                  # some empty splits
    empty[1, 1] = True                       # an all-empty (b, head)
    m[empty] = -1e30
    l[empty] = 0.0
    acc[empty] = 0.0
    want = jx.coll.merge_partial_softmax_stacked(
        jx.jnp.asarray(m), jx.jnp.asarray(l), jx.jnp.asarray(acc), axis=2)
    got = merge_partial_softmax_stacked(torch.from_numpy(m), torch.from_numpy(l),
                                        torch.from_numpy(acc), axis=2)
    _close(got, want, 1e-5)
    assert torch.isfinite(got).all()
    assert torch.equal(got[1, 1], torch.zeros(g, D))


def _partials(B, Hkv, K, g, D, seed=0, device="cpu"):
    """Split partials (m, l, acc) made with numpy: random ones, some empty
    splits (m = -1e30, l = 0, acc = 0) and one all-empty (b, kv head)."""
    rng = np.random.RandomState(seed)
    m = rng.randn(B, Hkv, K, g, 1).astype(np.float32) * 3
    l = rng.rand(B, Hkv, K, g, 1).astype(np.float32) * 4 + 0.1
    acc = rng.randn(B, Hkv, K, g, D).astype(np.float32)
    empty = rng.rand(B, Hkv, K, g) < 0.3
    empty[-1, -1] = True
    m[empty], l[empty], acc[empty] = -1e30, 0.0, 0.0
    return tuple(torch.from_numpy(t).to(device) for t in (m, l, acc))


@pytest.mark.parametrize("K", [1, 4, 7, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_partials_plain_matches_merge(jx, K, dtype):
    """`merge_partials_plain`, the combine kernel's twin (split order), is
    the JAX merge's function within 1e-5 (f32) and one bf16 rounding, and
    an all-empty (b, kv head) gives 0."""
    B, Hkv, g, D = 2, 3, 2, 24
    m, l, acc = _partials(B, Hkv, K, g, D, seed=K)
    got = paged_attention.merge_partials_plain(m, l, acc, dtype)
    assert got.shape == (B, Hkv * g, D) and got.dtype == dtype
    want = jx.coll.merge_partial_softmax_stacked(jx.arr(m), jx.arr(l), jx.arr(acc), axis=2)
    want = np.asarray(want, np.float32).reshape(B, Hkv * g, D)
    _close(got, want, 1e-5 if dtype == torch.float32 else 1e-2)
    _close(got, merge_partial_softmax_stacked(m, l, acc, axis=2).reshape(B, Hkv * g, D),
           1e-5 if dtype == torch.float32 else 1e-2)
    assert torch.equal(got[-1, -g:].float(), torch.zeros(g, D))


# ---------------------------------------------------------------------------
# Plain versions against the JAX oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("splits", [2, 5, 7, 8])
@pytest.mark.parametrize("opts", OPTS)
def test_split_plain_matches_oracle(jx, pool, splits, opts):
    q, k, v, ks, vs, tbl, lens = _case(pool, **SMALL)
    want = jx.ref.paged_attention_split_ref(
        *map(jx.arr, (q, k, v, tbl, lens, ks, vs)), kv_splits=splits,
        **_kw(opts, jx.bank))
    got = paged_attention.paged_attention_split_plain(
        q, k, v, tbl, lens, ks, vs, kv_splits=splits, **_kw(opts, TBANK))
    _close(got, want, 1e-5)
    assert torch.equal(got[0], torch.zeros_like(got[0]))    # length 0


@pytest.mark.parametrize("pool", POOLS[1:])
@pytest.mark.parametrize("opts", OPTS)
def test_decode_plain_scale_rows_match_oracle(jx, pool, opts):
    q, k, v, ks, vs, tbl, lens = _case(pool, **SMALL, seed=1)
    want = jx.ref.paged_attention_ref(*map(jx.arr, (q, k, v, tbl, lens, ks, vs)),
                                      **_kw(opts, jx.bank))
    got = paged_attention.paged_attention_plain(q, k, v, tbl, lens, ks, vs,
                                                **_kw(opts, TBANK))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("pool", POOLS[1:])
@pytest.mark.parametrize("opts", OPTS)
def test_prefill_plain_scale_rows_match_oracle(jx, pool, opts):
    starts = torch.tensor([0, 11], dtype=torch.int32)
    q, k, v, ks, vs, tbl, lens = _case(pool, B=2, H=4, Hkv=2, D=16, page=4,
                                       n_pages=5, lengths=[6, 17], Sq=6, seed=2)
    want = jx.ref.paged_prefill_attention_ref(
        *map(jx.arr, (q, k, v, tbl, lens, starts, ks, vs)), **_kw(opts, jx.bank))
    got = paged_prefill.paged_prefill_attention_plain(
        q, k, v, tbl, lens, starts, ks, vs, **_kw(opts, TBANK))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("pool", ["fp", "int8-f32", "int4"])
@pytest.mark.parametrize("opts", [{}, {"lut": True}, {"lut": True, "softcap": 5.0, "window": 6}])
def test_online_prefill_matches_pallas_interpret(jx, pool, opts):
    """`paged_prefill_attention_online_plain`, the page walk that the prefill
    kernel is held to in LUT mode, is the TPU kernel's own function: against
    the Pallas kernel in interpret mode, f32, within 1e-5 (exact and LUT)."""
    starts = torch.tensor([0, 11], dtype=torch.int32)
    q, k, v, ks, vs, tbl, lens = _case(pool, B=2, H=4, Hkv=2, D=16, page=4,
                                       n_pages=5, lengths=[6, 17], Sq=6, seed=2)
    want = jx.prefill.paged_prefill_attention(
        *map(jx.arr, (q, k, v, tbl, lens, starts, ks, vs)), interpret=True,
        **_kw(opts, jx.bank))
    got = paged_prefill.paged_prefill_attention_online_plain(
        q, k, v, tbl, lens, starts, ks, vs, **_kw(opts, TBANK))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("opts", [{}, {"softcap": 5.0, "window": 19}])
def test_prefill_page_walk_is_the_one_shot_softmax_in_fp64(pool, opts):
    """In fp64 the page walk (`paged_prefill_attention_online_plain`, the
    order of the prefill kernel's sums) and the one-shot softmax of
    `paged_prefill_attention_plain` round to the same bf16 bits: the order
    of an fp64 sum cannot show in a bf16 output, which is what lets the
    kernel match its plain version bit for bit."""
    q, k, v, ks, vs, tbl, lens = _case(pool, B=2, H=12, Hkv=2, D=32, page=4, n_pages=24,
                                       lengths=[40, 93], Sq=29, seed=11)
    q = (3 * q).bfloat16()
    if pool == "fp":
        k, v = k.bfloat16(), v.bfloat16()
    starts = lens - 29
    walk = paged_prefill.paged_prefill_attention_online_plain(q, k, v, tbl, lens, starts,
                                                              ks, vs, **opts)
    one_shot = paged_prefill.paged_prefill_attention_plain(q, k, v, tbl, lens, starts,
                                                          ks, vs, **opts)
    assert one_shot.dtype == torch.bfloat16 and float(one_shot.float().abs().amax()) > 0.5
    assert torch.equal(walk.to(torch.bfloat16), one_shot)


@pytest.mark.parametrize("pool", ["fp", "int8-f32", "int4"])
@pytest.mark.parametrize("splits", [4, 7])            # even and trash-padded
def test_split_plain_matches_pallas_interpret(jx, pool, splits):
    """A 64-page table of 16-token pages (1024 tokens) engages the split in
    both packages' dispatch."""
    q, k, v, ks, vs, tbl, lens = _case(pool, B=2, H=4, Hkv=2, D=16, page=16,
                                       n_pages=64, lengths=[1024, 700], seed=4)
    want = jx.paged.paged_attention(*map(jx.arr, (q, k, v, tbl, lens, ks, vs)),
                                    kv_splits=splits, interpret=True)
    got = ops.pim_paged_attention(q, k, v, tbl, lens, ks, vs, kv_splits=splits)
    _close(got, want, 1e-5)


def test_cpu_dispatch_splits_only_from_1024_tokens():
    q, k, v, ks, vs, tbl, lens = _case("int8-bf16", B=2, H=4, Hkv=2, D=16,
                                       page=16, n_pages=64, lengths=[1000, 64])
    split = paged_attention.paged_attention_split_plain(q, k, v, tbl, lens, ks, vs,
                                                        kv_splits=4)
    assert torch.equal(ops.pim_paged_attention(q, k, v, tbl, lens, ks, vs,
                                               kv_splits=4), split)
    short = tbl[:, :63].contiguous()                   # 1008 tokens: one walk
    assert torch.equal(ops.pim_paged_attention(q, k, v, short, lens, ks, vs,
                                               kv_splits=4),
                       paged_attention.paged_attention_plain(q, k, v, short, lens,
                                                             ks, vs))
    _close(split, paged_attention.paged_attention_plain(q, k, v, tbl, lens, ks, vs)
           .numpy(), 1e-5)


# (B, Hkv, K, n_table, g, D, row bytes) -> (cluster, window pages): GPT-2's
# 4 slots at 1024 keys (page 16) and K 4, 8 and 16; one slot at K = 4,
# whose 64 clusters grow to 4 blocks each; qwen2-1.5B's 131072
# keys at K = 8 and, at K = 2, runs walked in windows.
SPLIT_PLANS = [((4, 16, 4, 64, 1, 64, 128), (1, 16)), ((4, 16, 8, 64, 1, 64, 128), (1, 8)),
               ((4, 16, 16, 64, 1, 64, 128), (1, 4)), ((1, 16, 4, 64, 1, 64, 128), (4, 4)),
               ((1, 2, 8, 8192, 6, 128, 256), (8, 128)),
               ((1, 2, 2, 8192, 6, 128, 256), (8, 228))]


@pytest.mark.parametrize("shape,want", SPLIT_PLANS)
def test_split_plan_at_model_widths(shape, want):
    """`split_plan` gives each split a cluster of 1..8 blocks, grown while
    the B * Hkv * K clusters leave SMs idle and every block keeps a page of
    the split's run, and walks runs that outgrow shared memory in windows
    of whole ring stages, every window within it."""
    B, Hkv, K, n_table, g, D, row_bytes = shape
    cs, win = paged_attention.split_plan(B, Hkv, K, n_table, g, D, 16, row_bytes)
    assert (cs, win) == want
    pps = -(-n_table // K)
    assert cs <= pps and win <= -(-pps // cs)
    assert paged_attention.decode_smem_bytes(g, D, 16, win, row_bytes, cs) <= \
        paged_attention.DECODE_SMEM_MAX
    assert win == -(-pps // cs) or win % paged_attention.decode_chunk_pages(16, row_bytes,
                                                                           win) == 0


def test_split_plan_refuses_with_a_named_error():
    with pytest.raises(ValueError, match="paged_attention_split: not one page of 64 query"):
        paged_attention.split_plan(1, 1, 4, 64, 64, 512, 16, 1024)


# ---------------------------------------------------------------------------
# Launchers: argument checks, no CPU fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool,code", list(zip(POOLS, range(4))))
def test_pool_format_codes(pool, code):
    q, k, v, ks, vs, *_ = _case(pool, **SMALL)
    assert paged_attention.pool_format("t", q, k, v, ks, vs) == code


def test_pool_format_refusals():
    q, k, v, ks, vs, *_ = _case("int4", **SMALL)
    with pytest.raises(ValueError, match="both"):
        paged_attention.pool_format("t", q, k, v, ks, None)
    with pytest.raises(ValueError, match="bfloat16 scale rows"):
        paged_attention.pool_format("t", q, k, v, ks.float(), vs.float())
    with pytest.raises(ValueError, match="without scale rows"):
        paged_attention.pool_format("t", q, k, v, None, None)
    q8, k8, v8, ks8, vs8, *_ = _case("int8-f32", **SMALL)
    with pytest.raises(ValueError, match="must be int8"):
        paged_attention.pool_format("t", q8, k8.float(), v8.float(), ks8, vs8)
    with pytest.raises(ValueError, match="scale rows"):
        paged_attention.pool_format("t", q8, k8, v8, ks8[:, :1], vs8[:, :1])


def test_split_launchers_refuse_cpu_tensors():
    q, k, v, ks, vs, tbl, lens = _case("int8-f32", **SMALL)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.paged_attention_split(q, k, v, tbl, lens, ks, vs, kv_splits=2)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.paged_attention(q, k, v, tbl, lens, ks, vs, kv_splits=2)
    m = torch.zeros(3, 2, 2, 2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.merge_partials(m, m, torch.zeros(3, 2, 2, 2, 16), torch.float32)
    assert paged_attention.paged_attention_split.launches == 0
    assert paged_attention.merge_partials.launches == 0


# ---------------------------------------------------------------------------
# On the card: the kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m gpu` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, opts):
    return 3e-2 if dtype == torch.bfloat16 else (3e-3 if opts.get("lut") else 1e-4)


CARD = dict(B=3, H=8, Hkv=2, D=32, page=8, n_pages=16, lengths=[0, 77, 128])


@pytest.mark.gpu
@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("splits", [2, 4, 7])
@pytest.mark.parametrize("opts", OPTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_kernel_matches_plain(cuda, pool, splits, opts, dtype):
    q, k, v, ks, vs, tbl, lens = _case(pool, **CARD, device=cuda)
    q = q.to(dtype)
    if pool == "fp":
        k, v = k.to(dtype), v.to(dtype)
    kw = _kw(opts, TBANK)
    m, l, acc = paged_attention.paged_attention_split(q, k, v, tbl, lens, ks, vs,
                                                      kv_splits=splits, **kw)
    got = paged_attention.merge_partials(m, l, acc, dtype)
    unsplit = paged_attention.paged_attention(q, k, v, tbl, lens, ks, vs, **kw)
    torch.cuda.synchronize()
    want = paged_attention.paged_attention_split_plain(q, k, v, tbl, lens, ks, vs,
                                                       kv_splits=splits, **kw)
    _close(got, want.float().cpu().numpy(), _tol(dtype, opts))
    _close(got, unsplit.float().cpu().numpy(), _tol(dtype, opts))
    _close(merge_partial_softmax_stacked(m, l, acc, axis=2).reshape(got.shape),
           got.float().cpu().numpy(), _tol(dtype, {}))


@pytest.mark.gpu
@pytest.mark.parametrize("pool", POOLS[1:])
@pytest.mark.parametrize("opts", OPTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_decode_and_prefill_kernels_match_plain(cuda, pool, opts, dtype):
    kw = _kw(opts, TBANK)
    q, k, v, ks, vs, tbl, lens = _case(pool, **CARD, device=cuda)
    q = q.to(dtype)
    got = paged_attention.paged_attention(q, k, v, tbl, lens, ks, vs, **kw)
    torch.cuda.synchronize()
    want = paged_attention.paged_attention_plain(q, k, v, tbl, lens, ks, vs, **kw)
    _close(got, want.float().cpu().numpy(), _tol(dtype, opts))
    starts = torch.tensor([3, 40], dtype=torch.int32, device=cuda)
    q, k, v, ks, vs, tbl, lens = _case(pool, B=2, H=8, Hkv=2, D=32, page=8,
                                       n_pages=8, lengths=[9, 46], Sq=6, seed=5,
                                       device=cuda)
    q = q.to(dtype)
    got = paged_prefill.paged_prefill_attention(q, k, v, tbl, lens, starts, ks, vs, **kw)
    torch.cuda.synchronize()
    want = paged_prefill.paged_prefill_attention_plain(q, k, v, tbl, lens, starts,
                                                       ks, vs, **kw)
    _close(got, want.float().cpu().numpy(), _tol(dtype, opts))


# The single walk at 1024 keys with GQA g = 2: lengths from one key to the
# full table, page boundaries on either side.
LONG = dict(B=7, H=8, Hkv=4, D=64, page=16, n_pages=64,
            lengths=[1, 15, 16, 17, 200, 960, 1024])


@pytest.mark.gpu
@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("opts", OPTS + [{"lut": True, "softcap": 5.0, "window": 300}])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_long_gqa_matches_walk(cuda, pool, opts, dtype):
    """The single-walk kernel on every pool format at g = 2 over a 64-page
    table: exact mode against the plain version, LUT mode against the
    page-ordered walk (`paged_attention_online_plain`, the function it
    computes); f32 within 1e-4, bf16 within 3e-2."""
    q, k, v, ks, vs, tbl, lens = _case(pool, **LONG, seed=11, device=cuda)
    q = q.to(dtype)
    if pool == "fp":
        k, v = k.to(dtype), v.to(dtype)
    kw = _kw(opts, TBANK)
    before = paged_attention.paged_attention.launches
    got = paged_attention.paged_attention(q, k, v, tbl, lens, ks, vs, **kw)
    torch.cuda.synchronize()
    assert paged_attention.paged_attention.launches == before + 1
    if opts.get("lut"):
        want = paged_attention.paged_attention_online_plain(q, k, v, tbl, lens, ks, vs, **kw)
    else:
        want = paged_attention.paged_attention_plain(q, k, v, tbl, lens, ks, vs, **kw)
    _close(got, want.float().cpu().numpy(), 3e-2 if dtype == torch.bfloat16 else 1e-4)


# The single walk past one block's shared memory (bf16 pools): the table
# one page wider than the widest that 8 blocks of g = 2, head_dim 64 held
# whole before runs were walked in windows (4632 pages); a grid that
# covers the card (9 slots x 16 kv heads) whose 16384-key tables need two
# blocks a run; qwen2-1.5B's 131072 keys at g = 6, head_dim 128. Each row
# has 8 planted keys (`_plant_hot_keys`), so its output is O(1).
WIDE = [dict(B=1, H=2, Hkv=1, D=64, n_pages=4633, lengths=[16 * 4633], cluster=8),
        dict(B=9, H=32, Hkv=16, D=64, n_pages=1024, cluster=2,
             lengths=[1, 17, 5000, 9001, 12000, 16000, 16383, 16384, 16384]),
        dict(B=1, H=12, Hkv=2, D=128, n_pages=8192, lengths=[131072], cluster=8)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WIDE)
def test_decode_kernel_at_shared_memory_limits(cuda, case):
    """bf16 against the plain version within 3e-2 where the table's width,
    not the grid, sets the cluster, and where a run is walked in windows;
    the planted keys keep the outputs O(1), so the tolerance binds."""
    shape = dict(case)
    cluster = shape.pop("cluster")
    q, k, v, ks, vs, tbl, lens = _case("fp", page=16, **shape, seed=13, device=cuda, hot=8)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    B, H, Hkv, D, n_pages = (shape[n] for n in ("B", "H", "Hkv", "D", "n_pages"))
    cs, win = paged_attention.decode_plan(B, Hkv, n_pages, H // Hkv, D, 16, 2 * D)
    assert cs == cluster
    before = paged_attention.paged_attention.launches
    got = paged_attention.paged_attention(q, k, v, tbl, lens)
    torch.cuda.synchronize()
    assert paged_attention.paged_attention.launches == before + 1
    want = paged_attention.paged_attention_plain(q, k, v, tbl, lens)
    assert float(want[lens > 16].float().abs().amax()) > 0.5
    _close(got, want.float().cpu().numpy(), 3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("opts", [{}, {"lut": True}, {"lut": True, "window": 300}])
@pytest.mark.parametrize("heads", [(8, 2, 128), (4, 2, 64)])
@pytest.mark.parametrize("win_pages", [1, 3])
def test_decode_kernel_walks_windows(cuda, pool, opts, heads, win_pages):
    """The windowed walk forced at a few hundred keys: windows of 1 or 3
    pages (one ring stage) over runs of 12 pages (cluster 2, 24-page
    table), g * D of 512 (pairs summed one by one) and 128, every pool
    format, planted keys in every run; exact mode against the plain version
    and LUT mode against the page walk, within 3e-2 (bf16)."""
    H, Hkv, D = heads
    q, k, v, ks, vs, tbl, lens = _case(pool, B=3, H=H, Hkv=Hkv, D=D, page=16, n_pages=24,
                                       lengths=[384, 250, 97], seed=17, device=cuda, hot=6)
    q = q.bfloat16()
    if pool == "fp":
        k, v = k.bfloat16(), v.bfloat16()
    kw = _kw(opts, TBANK)
    fmt = paged_attention.pool_format("paged_attention", q, k, v, ks, vs)
    before = paged_attention.paged_attention.launches
    got = paged_attention.launch_decode(q, k, v, tbl, lens, ks, vs, fmt, 2, win_pages, **kw)
    torch.cuda.synchronize()
    assert paged_attention.paged_attention.launches == before + 1
    plain = (paged_attention.paged_attention_online_plain if opts.get("lut")
             else paged_attention.paged_attention_plain)
    want = plain(q, k, v, tbl, lens, ks, vs, **kw)
    assert float(want.float().abs().amax()) > 0.5
    _close(got, want.float().cpu().numpy(), 3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("opts", [{}, {"lut": True}, {"lut": True, "softcap": 5.0, "window": 300}])
def test_prefill_tensor_core_kernel_matches_walk(cuda, pool, opts):
    """bf16 chunks on the prefill kernel (one launch each; the kernel
    replaced the tensor-core one, whose fp32 sums left the plain version's
    bits) at g 1 and 2, Sq 1, 17 and 64, starts 0, 15, 64 and 896 of a
    64-page table: exact mode against the plain version, LUT mode against
    the page walk (`paged_prefill_attention_online_plain`), bit for bit
    (both sum in fp64); f32 chunks too."""
    kw = _kw(opts, TBANK)
    for g in (1, 2):
        for Sq in (1, 17, 64):
            for start in (0, 15, 64, 896):
                q, k, v, ks, vs, tbl, lens = _case(pool, B=1, H=8 * g, Hkv=8, D=64, page=16,
                                                   n_pages=64, lengths=[start + Sq], Sq=Sq,
                                                   seed=start + Sq + g, device=cuda)
                st = lens - Sq
                if pool == "fp":
                    k, v = k.bfloat16(), v.bfloat16()
                before = paged_prefill.paged_prefill_attention.launches
                got = paged_prefill.paged_prefill_attention(q.bfloat16(), k, v, tbl, lens, st,
                                                            ks, vs, **kw)
                torch.cuda.synchronize()
                assert paged_prefill.paged_prefill_attention.launches == before + 1
                plain = (paged_prefill.paged_prefill_attention_online_plain if opts.get("lut")
                         else paged_prefill.paged_prefill_attention_plain)
                want = plain(q.bfloat16(), k, v, tbl, lens, st, ks, vs, **kw)
                assert torch.equal(got, want.to(got.dtype))
    if pool != "fp":
        got = paged_prefill.paged_prefill_attention(q, k, v, tbl, lens, st, ks, vs, **kw)
        plain = (paged_prefill.paged_prefill_attention_online_plain if opts.get("lut")
                 else paged_prefill.paged_prefill_attention_plain)
        assert torch.equal(got, plain(q, k, v, tbl, lens, st, ks, vs, **kw).to(got.dtype))


# g = 6 over head_dim 64 and g = 8 over head_dim 128; a 66-page table of
# 16-token pages (1056 keys, wide enough for `paged_attention` to route
# kv_splits > 1 to the split), trash-padded for K = 4 (68 pages), 7 (70), 8
# (72) and 16 (80), with a one-key row (every split but the first wholly
# past its length) and a 250-key row (splits 4.. past it at K = 16).
SPLIT_HEADS = [(12, 2, 64), (8, 1, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("splits", [1, 2, 4, 7, 8, 16])
@pytest.mark.parametrize("lut", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", SPLIT_HEADS)
def test_split_kernel_on_planted_keys(cuda, pool, splits, lut, dtype, heads):
    """The split kernel on planted keys, its partials merged by
    `merge_partials`: exact mode against the plain split, LUT mode against
    the online walk over K runs, within the tolerances of
    `test_split_kernel_matches_plain`. For K > 1 `paged_attention(...,
    kv_splits=K)`, the route a decode step takes, launches those two
    kernels once each and returns the same bits."""
    H, Hkv, D = heads
    q, k, v, ks, vs, tbl, lens = _case(pool, B=3, H=H, Hkv=Hkv, D=D, page=16, n_pages=66,
                                       lengths=[1, 250, 640], seed=splits + D, device=cuda,
                                       hot=6)
    q = q.to(dtype)
    if pool == "fp":
        k, v = k.to(dtype), v.to(dtype)
    kw = _kw({"lut": lut}, TBANK)
    m, l, acc = paged_attention.paged_attention_split(q, k, v, tbl, lens, ks, vs,
                                                      kv_splits=splits, **kw)
    merged = paged_attention.merge_partials(m, l, acc, dtype)
    torch.cuda.synchronize()
    if lut:
        want = paged_attention.paged_attention_online_plain(q, k, v, tbl, lens, ks, vs,
                                                            splits=splits, **kw)
    else:
        want = paged_attention.paged_attention_split_plain(q, k, v, tbl, lens, ks, vs,
                                                           kv_splits=splits, **kw)
    assert float(want.float().abs().amax()) > 0.5
    _close(merged, want.float().cpu().numpy(), _tol(dtype, {"lut": lut}))
    assert bool((m[0, :, 1:] == -1e30).all()) and bool((l[0, :, 1:] == 0).all())
    if splits > 1:
        before = (paged_attention.paged_attention_split.launches,
                  paged_attention.merge_partials.launches)
        routed = paged_attention.paged_attention(q, k, v, tbl, lens, ks, vs,
                                                 kv_splits=splits, **kw)
        torch.cuda.synchronize()
        assert (paged_attention.paged_attention_split.launches,
                paged_attention.merge_partials.launches) == (before[0] + 1, before[1] + 1)
        assert torch.equal(routed, merged)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 2, 4, 7, 16, 40])
@pytest.mark.parametrize("g,D", [(1, 64), (2, 128), (6, 128), (12, 192), (1, 30), (3, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_partials_bit_for_bit(cuda, K, g, D, dtype):
    """The combine kernel (a warp a row, launched with programmatic stream
    serialization) is `merge_partials_plain` bit for bit: 16-byte pieces
    where D % 4 == 0, columns one by one where not, more than 32 splits,
    empty splits and an all-empty (b, kv head), one launch a call."""
    m, l, acc = _partials(4, 3, K, g, D, seed=K + D, device=cuda)
    before = paged_attention.merge_partials.launches
    got = paged_attention.merge_partials(m, l, acc, dtype)
    torch.cuda.synchronize()
    assert paged_attention.merge_partials.launches == before + 1
    assert torch.equal(got, paged_attention.merge_partials_plain(m, l, acc, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["fp", "int8-bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_route_replays_in_a_cuda_graph(cuda, pool, dtype):
    """`paged_attention(..., kv_splits=4)`: the split kernel, then the
    combine launched to overlap its tail, eager and captured in a CUDA
    graph (the programmatic edge survives capture), the same bits as the
    split's partials through `merge_partials_plain`."""
    q, k, v, ks, vs, tbl, lens = _case(pool, B=4, H=16, Hkv=16, D=64, page=16, n_pages=66,
                                       lengths=[960, 981, 1003, 1020], seed=7, device=cuda)
    q = q.to(dtype)
    if pool == "fp":
        k, v = k.to(dtype), v.to(dtype)
    m, l, acc = paged_attention.paged_attention_split(q, k, v, tbl, lens, ks, vs, kv_splits=4)
    want = paged_attention.merge_partials_plain(m, l, acc, dtype)
    eager = paged_attention.paged_attention(q, k, v, tbl, lens, ks, vs, kv_splits=4)
    torch.cuda.synchronize()
    assert torch.equal(eager, want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_attention.paged_attention(q, k, v, tbl, lens, ks, vs, kv_splits=4)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attention.paged_attention(q, k, v, tbl, lens, ks, vs, kv_splits=4)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


# The RoPE models' attention heads, 2 kv heads each: (g, head_dim, the
# options their layers pass). qwen2-1.5B g 6 x 128; gemma2-2B g 2 x 256
# with softcap 50 and a 4096-token window; h2o-danube3-4B g 4 x 120 (bf16
# rows of 240 bytes, int4 rows of 60: not whole 16-byte pieces) with the
# window; nemotron-4-340B g 12 x 192.
MODEL_HEADS = [(6, 128, {}), (2, 256, {"softcap": 50.0, "window": 4096}),
               (4, 120, {"window": 4096}), (12, 192, {})]


@pytest.mark.gpu
@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("lut", [False, True])
@pytest.mark.parametrize("heads", MODEL_HEADS)
def test_decode_kernel_at_model_heads(cuda, pool, lut, heads):
    """The single walk over a 300-page table (4800 keys), lengths 4700,
    1500 and 1, bf16 queries on every pool format, planted keys: exact mode
    against the plain version, LUT mode against the page walk, within 3e-2;
    the window cuts the 4700-key row."""
    g, D, opts = heads
    q, k, v, ks, vs, tbl, lens = _case(pool, B=3, H=2 * g, Hkv=2, D=D, page=16, n_pages=300,
                                       lengths=[4700, 1500, 1], seed=D + g, device=cuda,
                                       hot=8)
    q = q.bfloat16()
    if pool == "fp":
        k, v = k.bfloat16(), v.bfloat16()
    kw = _kw(dict(opts, lut=lut), TBANK)
    before = paged_attention.paged_attention.launches
    got = paged_attention.paged_attention(q, k, v, tbl, lens, ks, vs, **kw)
    torch.cuda.synchronize()
    assert paged_attention.paged_attention.launches == before + 1
    plain = (paged_attention.paged_attention_online_plain if lut
             else paged_attention.paged_attention_plain)
    want = plain(q, k, v, tbl, lens, ks, vs, **kw)
    assert float(want.float().abs().amax()) > 0.5
    _close(got, want.float().cpu().numpy(), 3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("lut", [False, True])
@pytest.mark.parametrize("heads", MODEL_HEADS)
def test_prefill_kernel_at_model_heads(cuda, pool, lut, heads):
    """bf16 chunks over a 300-page table: 64 queries at start 0, 17 at 15
    and 64 at 4400 (past the 4096-token window), queries of std 4 so that a
    few keys dominate each row; exact mode against the plain version, LUT
    mode against the page walk, bit for bit (both sum in fp64)."""
    g, D, opts = heads
    kw = _kw(dict(opts, lut=lut), TBANK)
    for Sq, start in ((64, 0), (17, 15), (64, 4400)):
        q, k, v, ks, vs, tbl, lens = _case(pool, B=1, H=2 * g, Hkv=2, D=D, page=16,
                                           n_pages=300, lengths=[start + Sq], Sq=Sq,
                                           seed=start + D, device=cuda)
        q = (4 * q).bfloat16()
        if pool == "fp":
            k, v = k.bfloat16(), v.bfloat16()
        st = lens - Sq
        before = paged_prefill.paged_prefill_attention.launches
        got = paged_prefill.paged_prefill_attention(q, k, v, tbl, lens, st, ks, vs, **kw)
        torch.cuda.synchronize()
        assert paged_prefill.paged_prefill_attention.launches == before + 1
        plain = (paged_prefill.paged_prefill_attention_online_plain if lut
                 else paged_prefill.paged_prefill_attention_plain)
        want = plain(q, k, v, tbl, lens, st, ks, vs, **kw)
        assert torch.equal(got, want.to(got.dtype))
