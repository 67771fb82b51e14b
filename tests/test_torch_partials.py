"""`decode_attention_partials`, the dense decode walk over one rank's slice of
a sequence-sharded arena, and its plain version
`decode_attention_partials_plain` (kernels/decode_attention.py).

On the CPU: slices of an arena of random keys at their key offsets, merged
by the log-sum-exp algebra (the cross-rank merge of
`collectives.merge_partial_softmax`, here over a stacked axis), equal
`decode_attention_online_plain` on the whole arena within 1e-6 in f32, with
windows that cross the slices, a softcap and the int8 arena; one slice
holding the whole arena is bit for bit the online walk, also in LUT mode
(where slices merged by the exact exp are a different function, LUT(a)
LUT(b) != LUT(a + b), held to the LUT's own 1e-2); a slice with no valid
key gives m = -inf, l = 0, acc = 0, and the merge weighs it 0, with no
NaN. On meta tensors the plain version runs without reading a value.

On the card (marker `gpu`): the kernel within atol = rtol = 1e-4 of the
plain version at every offset and element, in both dtypes (the partials
are f32 either way: bf16 inputs widen exactly and both sum in f32), and a
whole-arena slice normalised bit for bit `decode_attention` (one walk, two
epilogues). No JAX here: the file runs on the card.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import lut as tlut
from repro_torch.kernels import decode_attention as da
from repro_torch.serving.quantize import quantize_vec

B, H, HKV, S, D = 3, 8, 2, 1024, 16
LENGTHS = [1024, 517, 3]
OPTS = [{}, {"window": 300}, {"window": 40, "softcap": 5.0}]
SLICES = [1, 2, 4, 8]


def _arena(seed, device="cpu", int8=False):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(device)
               for s in ((B, H, D), (B, HKV, S, D), (B, HKV, S, D)))
    length = torch.tensor(LENGTHS, dtype=torch.int32, device=device)
    if not int8:
        return q, k, v, length, None, None
    (k8, ks), (v8, vs) = (quantize_vec(t, torch.bfloat16) for t in (k, v))
    return q, k8, v8, length, ks, vs


def _slices(k, v, ks, vs, n):
    w = k.shape[2] // n
    for i in range(n):
        sl = slice(i * w, (i + 1) * w)
        yield (i * w, k[:, :, sl].contiguous(), v[:, :, sl].contiguous(),
               None if ks is None else ks[:, :, sl].contiguous(),
               None if vs is None else vs[:, :, sl].contiguous())


def _merge(parts):
    m, l, acc = (torch.stack(t) for t in zip(*parts))
    m_glob = m.amax(0, keepdim=True)
    m_glob = torch.where(torch.isfinite(m_glob), m_glob, 0.0)
    corr = torch.exp(m - m_glob)
    return (acc * corr).sum(0) / torch.clamp((l * corr).sum(0), min=1e-9)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("opts", OPTS)
@pytest.mark.parametrize("n", SLICES)
def test_merged_slices_equal_the_online_walk(n, opts, int8):
    q, k, v, length, ks, vs = _arena(n, int8=int8)
    want = da.decode_attention_online_plain(q, k, v, length, ks, vs, **opts)
    parts = [da.decode_attention_partials_plain(q, kk, vv, length, kks, vvs, key_offset=o,
                                                **opts)
             for o, kk, vv, kks, vvs in _slices(k, v, ks, vs, n)]
    got = _merge(parts)
    assert float((got - want).abs().max()) <= 1e-6
    assert all(bool(torch.isfinite(p[1]).all() and torch.isfinite(p[2]).all()) for p in parts)


@pytest.mark.parametrize("opts", OPTS)
@pytest.mark.parametrize("lut", [False, True])
def test_one_slice_is_the_online_walk_bit_for_bit(opts, lut):
    q, k, v, length, _, _ = _arena(7)
    kw = dict(opts, exp_table=tlut.LutBank.create(64).exp if lut else None)
    m, l, acc = da.decode_attention_partials_plain(q, k, v, length, key_offset=0, **kw)
    got = acc / torch.clamp(l, min=1e-9)
    assert torch.equal(got, da.decode_attention_online_plain(q, k, v, length, **kw))
    # Slices merged by the exact exp: another function in LUT mode.
    merged = _merge([da.decode_attention_partials_plain(q, kk, vv, length, key_offset=o, **kw)
                     for o, kk, vv, _, _ in _slices(k, v, None, None, 4)])
    assert float((merged - got).abs().max()) <= (1e-2 if lut else 1e-6)


def test_an_empty_slice_weighs_nothing():
    q, k, v, length, _, _ = _arena(3)
    # Row 2 holds 3 keys: every slice past the first is empty for it; with
    # a window of 2 at length 517, row 1's keys 515..516 lie in slice 2 of 4.
    parts = [da.decode_attention_partials_plain(q, kk, vv, length, key_offset=o, window=2)
             for o, kk, vv, _, _ in _slices(k, v, None, None, 4)]
    for i, (m, l, acc) in enumerate(parts):
        if i:
            assert bool(torch.isneginf(m[2]).all()) and not bool(l[2].any())
            assert not bool(acc[2].any())
        if i != 2:
            assert bool(torch.isneginf(m[1]).all()) and not bool(l[1].any())
    got = _merge(parts)
    assert bool(torch.isfinite(got).all())
    want = da.decode_attention_online_plain(q, k, v, length, window=2)
    assert float((got - want).abs().max()) <= 1e-6
    # Every slice empty (a row of length 0): 0, not NaN.
    zero = torch.zeros(B, dtype=torch.int32)
    m, l, acc = da.decode_attention_partials_plain(q, k, v, zero, key_offset=0)
    assert bool(torch.isneginf(m).all()) and not bool(l.any())
    assert not bool(_merge([(m, l, acc), (m, l, acc)]).any())


def test_the_plain_version_runs_on_meta_tensors():
    q, k, v = (torch.empty(s, device="meta") for s in ((B, H, D), (B, HKV, 512, D),
                                                       (B, HKV, 512, D)))
    length = torch.empty(B, dtype=torch.int32, device="meta")
    m, l, acc = da.decode_attention_partials_plain(q, k, v, length, key_offset=512, window=64)
    assert (m.shape, l.shape, acc.shape) == ((B, H, 1), (B, H, 1), (B, H, D))
    assert acc.device.type == "meta" and acc.dtype == torch.float32


def test_the_kernel_refuses_cpu_tensors():
    q, k, v, length, _, _ = _arena(0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        da.decode_attention_partials(q, k, v, length, key_offset=0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m gpu` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("opts", OPTS)
@pytest.mark.parametrize("n", [1, 4])
def test_kernel_matches_plain(cuda, n, opts, int8, dtype):
    q, k, v, length, ks, vs = _arena(n, device=cuda, int8=int8)
    q = q.to(dtype)
    if not int8:
        k, v = k.to(dtype), v.to(dtype)
    tol = 1e-4
    for o, kk, vv, kks, vvs in _slices(k, v, ks, vs, n):
        got = da.decode_attention_partials(q, kk, vv, length, kks, vvs, key_offset=o, **opts)
        torch.cuda.synchronize()
        want = da.decode_attention_partials_plain(q, kk, vv, length, kks, vvs, key_offset=o,
                                                  **opts)
        for g, w in zip(got, want):
            assert torch.equal(torch.isneginf(g), torch.isneginf(w))
            g, w = (torch.where(torch.isneginf(t), 0.0, t) for t in (g, w))
            assert bool(((g - w).abs() <= tol + tol * w.abs()).all())
    if n == 1:
        m, l, acc = got
        whole = da.decode_attention(q, k, v, length, ks, vs, **opts)
        assert torch.equal((acc / torch.clamp(l, min=1e-9)).to(dtype), whole)
