"""The port's write-time KV quantization against the JAX package, bit for
bit: `quantize_vec` / `quantize_vec_int4` and their dequants (f32 and bf16
scales, exact .5 ties), `pack_int4` / `unpack_int4` over every byte, the
quantizing appends into int8/int4 pools, and the byte and split rules
(`kv_vector_bytes`, `page_kv_bytes`, `effective_kv_splits`) over a grid
of arguments; and the int8 weights' linear layer, `qtensor_linear`, on
leading axes, with the bias in its own dtype and the LUT in its epilogue,
against the JAX `qtensor_linear` followed by the JAX LUT."""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gpt2_medium as jax_gpt2
from repro.kernels import paged_attention as jpaged
from repro.serving import kvcache as jkv
from repro.serving import quantize as jq
from repro_torch.configs import gpt2_medium
from repro_torch.kernels import paged_attention as tpaged
from repro_torch.serving import kvcache as tkv
from repro_torch.serving import quantize as tq

SCALES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(x) -> np.ndarray:
    """The bit pattern of a JAX array or torch tensor, as numpy integers."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    if x.dtype == np.float32:
        return x.view(np.uint32)
    return x


def _same_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _vectors(amax: float, seed: int = 0) -> np.ndarray:
    """(3, 4, 16) f32 vectors: random ones, and rows whose amax makes the
    scale exactly 1 or 2, so that x / scale lands on .5 ties."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(3, 4, 16) * 2).astype(np.float32)
    ties = np.arange(16, dtype=np.float32) - 7.5           # -7.5 .. 7.5
    x[0, 0] = np.clip(ties, -amax, amax)
    x[0, 0, 0] = amax                                       # scale 1
    x[0, 1] = 2 * x[0, 0]                                   # scale 2
    x[0, 2] = np.where(np.arange(16) % 2, 0.5, -2.5)
    x[0, 2, 3] = -amax                                      # negative amax
    x[0, 3] = 0.0                                           # all-zero vector
    return x


@pytest.mark.parametrize("scale_dtype", sorted(SCALES))
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_and_dequantize_bit_exact(scale_dtype, x_dtype, bits):
    jsd, tsd = SCALES[scale_dtype]
    x = _vectors(127.0 if bits == 8 else 7.0)
    jx = jnp.asarray(x).astype(getattr(jnp, x_dtype))
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    if bits == 8:
        jq_, js = jq.quantize_vec(jx, scale_dtype=jsd)
        tq_, ts = tq.quantize_vec(tx, scale_dtype=tsd)
        deq = (jq.dequantize_vec, tq.dequantize_vec)
    else:
        jq_, js = jq.quantize_vec_int4(jx, scale_dtype=jsd)
        tq_, ts = tq.quantize_vec_int4(tx, scale_dtype=tsd)
        deq = (jq.dequantize_vec_int4, tq.dequantize_vec_int4)
    assert tq_.dtype == torch.int8 and ts.dtype == tsd
    _same_bits(tq_, jq_)
    _same_bits(ts, js)
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        _same_bits(deq[1](tq_, ts, td), deq[0](jq_, js, jd))


def test_ties_round_half_to_even():
    q, s = tq.quantize_vec(torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5]]))
    assert float(s) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -2]]


def test_unpack_int4_every_byte():
    p = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    got = tq.unpack_int4(torch.from_numpy(p))
    _same_bits(got, jq.unpack_int4(jnp.asarray(p)))
    assert got.dtype == torch.int8 and got.shape == (16, 32)
    assert int(got.min()) == -8 and int(got.max()) == 7


def test_pack_int4_every_pair():
    pairs = np.asarray(list(itertools.product(range(-8, 8), repeat=2)), np.int8)
    q = np.concatenate([pairs[:, :1], pairs[:, 1:]], axis=-1)       # (256, 2)
    got = tq.pack_int4(torch.from_numpy(q))
    _same_bits(got, jq.pack_int4(jnp.asarray(q)))
    assert sorted(got[:, 0].tolist()) == list(range(-128, 128))      # a bijection
    _same_bits(tq.unpack_int4(got), q)


POOL_FORMATS = [("int8", "float32"), ("int8", "bfloat16"), ("int4", "bfloat16")]
P, HKV, PAGE, D = 9, 4, 4, 16      # the smoke config: 4 kv heads, head_dim 16


def _pools(kv, scale_dtype):
    """One layer's payload and scale pools, in both frameworks, filled with
    random values so that the entries a write must not touch compare too."""
    rng = np.random.RandomState(5)
    dp = D // 2 if kv == "int4" else D
    payload = rng.randint(-100, 100, size=(P, HKV, PAGE, dp)).astype(np.int8)
    jsd, tsd = SCALES[scale_dtype]
    scales = np.asarray(jnp.asarray(rng.rand(P, HKV, PAGE), jsd).astype(jnp.float32))
    j = [jnp.asarray(payload)] * 2 + [jnp.asarray(scales, jsd)] * 2
    t = ([torch.from_numpy(payload.copy()) for _ in range(2)]
         + [torch.from_numpy(scales.copy()).to(tsd) for _ in range(2)])
    return j, t


@pytest.mark.parametrize("kv,scale_dtype", POOL_FORMATS)
def test_append_kv_pages_bit_exact(kv, scale_dtype):
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _pools(kv, scale_dtype)
    rng = np.random.RandomState(1)
    tables = np.asarray([[3, 5, 0, 0], [8, 1, 2, 0], [6, 7, 4, 0]], np.int32)
    lengths = np.asarray([2, 9, 5], np.int32)
    k_new = rng.randn(3, HKV, D).astype(np.float32)
    v_new = rng.randn(3, HKV, D).astype(np.float32)
    want = jkv.append_kv_pages(jk, jv, jnp.asarray(tables), jnp.asarray(lengths),
                               jnp.asarray(k_new), jnp.asarray(v_new), jks, jvs)
    got = tkv.append_kv_pages(tk, tv, torch.from_numpy(tables),
                              torch.from_numpy(lengths), torch.from_numpy(k_new),
                              torch.from_numpy(v_new), tks, tvs)
    assert got[0] is tk and got[2] is tks                  # written in place
    for g, w in zip(got, want):
        _same_bits(g, w)


@pytest.mark.parametrize("kv,scale_dtype", POOL_FORMATS)
def test_append_chunk_kv_pages_bit_exact(kv, scale_dtype):
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _pools(kv, scale_dtype)
    rng = np.random.RandomState(2)
    tables = np.asarray([[3, 5, 0, 0], [8, 1, 2, 6]], np.int32)
    start = np.asarray([1, 7], np.int32)
    k_new = rng.randn(2, 6, HKV, D).astype(np.float32)
    v_new = rng.randn(2, 6, HKV, D).astype(np.float32)
    want = jkv.append_chunk_kv_pages(jk, jv, jnp.asarray(tables), jnp.asarray(start),
                                     jnp.asarray(k_new), jnp.asarray(v_new), jks, jvs)
    got = tkv.append_chunk_kv_pages(tk, tv, torch.from_numpy(tables),
                                    torch.from_numpy(start), torch.from_numpy(k_new),
                                    torch.from_numpy(v_new), tks, tvs)
    assert len(got) == 4
    for g, w in zip(got, want):
        _same_bits(g, w)


@pytest.mark.parametrize("kv", ["model", "int8", "int4"])
@pytest.mark.parametrize("scale_dtype", sorted(SCALES))
def test_init_paged_cache_matches_jax(kv, scale_dtype):
    jc = jkv.init_paged_cache(jax_gpt2.smoke_config(), 2, 7, 4, 3, kv_dtype=kv,
                              kv_scale_dtype=scale_dtype)
    tc = tkv.init_paged_cache(gpt2_medium.smoke_config(), 2, 7, 4, 3, kv_dtype=kv,
                              kv_scale_dtype=scale_dtype, device="cpu")
    assert tc.quantized == jc.quantized == (kv != "model")
    for name in ("lengths", "block_tables", "k_pages", "v_pages", "k_scale", "v_scale"):
        j, t = getattr(jc, name), getattr(tc, name)
        if j is None:
            assert t is None
            continue
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[1] == str(j.dtype)
        _same_bits(t, j)


def test_kv_vector_bytes_and_split_rule_match_jax():
    for D, kv, sd, pd in itertools.product(
            [16, 64, 128], ["model", "int8", "int4"], sorted(SCALES),
            [("float32", jnp.float32, torch.float32),
             ("bfloat16", jnp.bfloat16, torch.bfloat16)]):
        assert (tpaged.kv_vector_bytes(D, kv, sd, pd[2])
                == jpaged.kv_vector_bytes(D, kv, sd, pd[1])), (D, kv, sd, pd[0])
    assert tpaged.KV_SPLIT_MIN_CONTEXT == jpaged.KV_SPLIT_MIN_CONTEXT
    for k, n, page in itertools.product([None, 0, 1, 2, 4, 7, 100],
                                        [1, 16, 63, 64, 65, 256], [4, 16, 32]):
        assert (tpaged.effective_kv_splits(k, n, page)
                == jpaged.effective_kv_splits(k, n, page)), (k, n, page)


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_page_kv_bytes_matches_jax(which):
    jcfg = jax_gpt2.smoke_config() if which == "smoke" else jax_gpt2.config()
    tcfg = gpt2_medium.smoke_config() if which == "smoke" else gpt2_medium.config()
    for page, kv, sd in itertools.product([1, 4, 16], ["model", "int8", "int4"],
                                          sorted(SCALES)):
        assert (tkv.page_kv_bytes(tcfg, page, kv, sd)
                == jkv.page_kv_bytes(jcfg, page, kv, sd)), (page, kv, sd)


# ---------------------------------------------------------------------------
# qtensor_linear: the int8 weights' linear layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype", list(SCALES))
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("lut", [False, True])
def test_qtensor_linear_matches_jax(x_dtype, bias, lut):
    """x (2, 3, C) through a QTensor (R, C): x quantized per row in f32, the
    bias in x's dtype added in f32, cast to x's dtype, then (with a table)
    the LUT GELU on the cast value, bit for bit the JAX `qtensor_linear`
    followed by the JAX LUT; on the CPU the plain twin of the one-launch
    int8 linear layer."""
    from repro.core import lut as jlut
    from repro_torch.core import lut as tlut
    jd, td = SCALES[x_dtype]
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 3, 48) * 1.5).astype(np.float32)
    w = (rng.randn(40, 48) * 48 ** -0.5).astype(np.float32)
    b = (rng.randn(40) * 0.5).astype(np.float32)
    jw = jq.quantize_leaf(jnp.asarray(w).astype(jd))
    qw = tq.QTensor(torch.from_numpy(np.asarray(jw.w_i8)),
                    torch.from_numpy(np.asarray(jw.scale)))
    jb = jnp.asarray(b).astype(jd) if bias else None
    tb = torch.from_numpy(b).to(td) if bias else None
    want = jq.qtensor_linear(jnp.asarray(x).astype(jd), jw, jb)
    table = tlut.LutBank.create(64).gelu if lut else None
    if lut:
        want = jlut.apply_table(want, jlut.LutBank.create(64).gelu)
    got = tq.qtensor_linear(torch.from_numpy(x).to(td), qw, tb, act_table=table)
    assert got.shape == (2, 3, 40) and got.dtype == td
    _same_bits(got, want)
