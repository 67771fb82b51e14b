"""`work.py` against hand counts."""
import pytest

from portbench import work

GPT2 = work.Dims(n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
                 d_ff=4096, vocab=50257, qkv_bias=True)
NEMO = work.Dims(n_layers=6, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
                 d_ff=73728, vocab=256000, qkv_bias=False)


def test_one_linear():
    # w_up of GPT-2 medium at 4 rows: 4096 x 1024 weights, 4 x 1024 in, 4 x 4096 out.
    f, b = work.linear(4, 4096, 1024, 2)
    assert f == 2 * 4 * 4096 * 1024
    assert b == 2 * (4096 * 1024 + 4 * 1024 + 4 * 4096)


def test_one_decode_attention():
    # Two rows holding 100 and 300 keys: K and V of 400 keys x 8 kv heads x
    # 192, q and out of 2 rows x 96 heads x 192, bf16.
    f, b = work.decode_attn(2, 400, NEMO)
    assert b == 2 * (2 * 400 * 8 * 192 + 2 * 2 * 96 * 192)
    assert f == 4 * 96 * 192 * 400


def test_one_prefill_chunk():
    # 3 queries at positions 5, 6, 7 see 6, 7 and 8 keys: 21 pairs; 8 keys'
    # K and V; q and out of 3 rows.
    f, b = work.prefill_attn(5, 3, GPT2)
    assert f == 4 * 16 * 64 * 21
    assert b == 2 * (2 * 8 * 16 * 64 + 2 * 3 * 16 * 64)


def test_decode_step_streams_the_weights():
    w = work.step(NEMO, 64, 64 * 300, None)
    layer = 18432 * (96 * 192 + 2 * 8 * 192) + 96 * 192 * 18432 + 2 * 18432 * 73728
    weights = 2 * (6 * layer + 256000 * 18432)
    # The weights, and 64 rows of activations in and out of each linear.
    assert weights < w["linear"].bytes < weights * 1.01
    # 50.9 GB: 15.2 ms at 3.35 TB/s; the step adds its K/V and norms.
    assert w["linear"].least_s == pytest.approx(0.0152, rel=0.01)
    kv = 2 * 6 * 2 * 64 * 300 * 8 * 192
    assert work.total(w).least_s == pytest.approx(
        (w["linear"].bytes + w["norm"].bytes + kv) / work.PEAK_BYTES, rel=1e-3)


def test_chunk_is_bound_by_flops():
    w = work.step(NEMO, 0, 0, (0, 512))
    assert w["decode_attn"].flops == 0
    assert w["linear"].flops / work.PEAK_FLOPS > w["linear"].bytes / work.PEAK_BYTES
    assert w["prefill_attn"].flops == 6 * 4 * 96 * 192 * (512 * 513 // 2)
