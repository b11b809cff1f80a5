"""The flash-attention kernel's plain version (``attention_plain``) and its
wrapper on CPU tensors, against the JAX package's Pallas kernel
``flash_attention`` (interpret mode) and its oracle ``attention_ref``, on
the same numpy-seeded inputs.

  · tests/test_kernels.py::test_flash_attention_sweep's grid (f32 and
    bf16, S 128 and 256, hd 32, 64 and 128, causal or not) at that test's
    tolerances, 2e-5 for f32 and 2e-2 for bf16;
  · GQA (KV heads 1 and 2 under 4 query heads), ragged S and Sq < Sk
    against ``attention_ref`` on the KV heads repeated on the JAX side;
  · causal Sq > Sk raises ValueError (ROADMAP §3, F4: there the Pallas
    kernel and its oracle disagree); non-causal Sq > Sk (Whisper's cross
    attention) is taken, and the wrapper equals ``attention_ref`` there;
  · the wrapper runs ``attention_plain`` on CPU tensors and counts no
    launch.

The port keeps q (B, Sq, H, hd) and k, v (B, Sk, KV, hd); the JAX kernel
takes (B, H, S, hd) with the KV heads repeated: the layout change and the
repeat are made on the JAX side only.  The CUDA kernel itself is held
against ``attention_plain`` on the card by tests/test_torch_cuda.py and
chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tf32 import SPLITS, tf32, tf32_mm, tf32_toward_zero
from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import attention_plain

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}     # tests/test_kernels.py's


def inputs(seed, b, sq, sk, h, kv, hd, dtype):
    """Port-layout tensors and the JAX kernel's (B, H, S, hd) arrays with
    the KV heads repeated, from the same numpy draws (rounded to dtype
    once, on the torch side)."""
    rng = np.random.default_rng(seed)
    host = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(tdt) for x in host)

    def to_jax(t, repeat):
        a = jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
        return jnp.transpose(jnp.repeat(a, repeat, axis=2), (0, 2, 1, 3))

    return (q, k, v), (to_jax(q, 1), to_jax(k, h // kv), to_jax(v, h // kv))


def check(got, want, dtype):
    tol = TOLS[dtype]
    want = np.transpose(np.asarray(want.astype(jnp.float32)), (0, 2, 1, 3))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,hd,bq,bk", [(128, 32, 64, 64),
                                        (256, 64, 128, 128),
                                        (256, 128, 128, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_and_oracle(dtype, s, hd, bq, bk, causal):
    (q, k, v), (jq, jk, jv) = inputs(s + hd, 1, s, s, 2, 2, hd, dtype)
    got = attention_plain(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    check(got, jflash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                      interpret=True), dtype)
    check(got, attention_ref(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", [1, 2])
@pytest.mark.parametrize("sq,sk", [(63, 63), (37, 100), (1, 45)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_gqa_ragged_against_oracle(dtype, kv, sq, sk, causal):
    (q, k, v), (jq, jk, jv) = inputs(sq * 7 + sk, 2, sq, sk, 4, kv, 16,
                                     dtype)
    check(attention_plain(q, k, v, causal=causal),
          attention_ref(jq, jk, jv, causal=causal), dtype)


def test_plain_gqa_against_pallas():
    """Grouped heads with Sq < Sk on both sides of the JAX kernel's
    right-aligned mask: 2 KV heads under 4 query heads, 64 queries over
    128 keys."""
    (q, k, v), (jq, jk, jv) = inputs(5, 2, 64, 128, 4, 2, 32, "float32")
    for causal in (True, False):
        check(attention_plain(q, k, v, causal=causal),
              jflash(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                     interpret=True), "float32")


@pytest.mark.parametrize("fn", [attention_plain, K.flash_attention])
def test_more_queries_than_keys_raise(fn):
    (q, k, v), _ = inputs(0, 1, 8, 4, 2, 1, 16, "float32")
    with pytest.raises(ValueError, match="Sq = 8 > Sk = 4"):
        fn(q, k, v)


@pytest.mark.parametrize("kv", [1, 4])
@pytest.mark.parametrize("sq,sk", [(8, 4), (100, 30)])
def test_non_causal_more_queries_than_keys(sq, sk, kv):
    """Without the mask every query sees every key, so Sq > Sk is in the
    contract: the wrapper on CPU tensors runs attention_plain, which
    equals the oracle; causal Sq > Sk still raises (F4)."""
    (q, k, v), (jq, jk, jv) = inputs(sq + sk + kv, 2, sq, sk, 4, kv, 16,
                                     "float32")
    before = K.flash_attention.launches
    got = K.flash_attention(q, k, v, causal=False)
    assert K.flash_attention.launches == before
    assert got.shape == q.shape
    check(got, attention_ref(jq, jk, jv, causal=False), "float32")
    with pytest.raises(ValueError, match=f"Sq = {sq} > Sk = {sk}"):
        K.flash_attention(q, k, v, causal=True)


def test_bad_head_grouping_raises():
    (q, k, v), _ = inputs(0, 1, 8, 8, 4, 3, 16, "float32")
    with pytest.raises(ValueError, match="4 query heads"):
        K.flash_attention(q, k, v)


@pytest.mark.parametrize("causal", [True, False])
def test_wrapper_on_cpu_runs_plain(causal):
    (q, k, v), _ = inputs(1, 2, 40, 50, 4, 2, 16, "float32")
    before = K.flash_attention.launches
    got = K.flash_attention(q, k, v, causal=causal)
    assert K.flash_attention.launches == before
    assert torch.equal(got, attention_plain(q, k, v, causal=causal))


def test_plain_in_f64_computes_in_f64():
    """f64 inputs give an f64 result (the card's truth for the f32 forms);
    it agrees with the f32 result to f32 precision."""
    (q, k, v), _ = inputs(2, 1, 32, 32, 4, 1, 16, "float32")
    got = attention_plain(q.double(), k.double(), v.double())
    assert got.dtype == torch.float64
    torch.testing.assert_close(got.float(), attention_plain(q, k, v),
                               rtol=2e-5, atol=2e-5)


def test_pallas_kernel_and_oracle_disagree_when_sq_exceeds_sk():
    """ROADMAP §3, F4, reproduced on the JAX package: with 128 causal
    queries over 64 keys, the first 64 rows see no key.  The Pallas kernel
    skips their only k-block and returns 0 there; its oracle's softmax
    over an all-masked row averages V over every key.  The rows that see
    keys agree.  The port's contract is therefore Sq <= Sk."""
    rng = np.random.default_rng(4)
    q = jnp.asarray(rng.standard_normal((1, 2, 128, 32), dtype=np.float32))
    k, v = (jnp.asarray(rng.standard_normal((1, 2, 64, 32),
                                            dtype=np.float32))
            for _ in range(2))
    got = np.asarray(jflash(q, k, v, causal=True, block_q=64, block_k=64,
                            interpret=True))
    want = np.asarray(attention_ref(q, k, v, causal=True))
    blind, seeing = slice(0, 64), slice(64, 128)
    assert not got[:, :, blind].any()
    np.testing.assert_allclose(
        want[:, :, blind],
        np.broadcast_to(np.asarray(v).mean(axis=2, keepdims=True),
                        want[:, :, blind].shape), rtol=1e-5, atol=1e-5)
    assert np.abs(got - want)[:, :, blind].max() > 0.1
    np.testing.assert_allclose(got[:, :, seeing], want[:, :, seeing],
                               rtol=2e-5, atol=2e-5)


def tf32_attention(q, k, v, passes, split="kernel"):
    """Causal attention of the kernel's arithmetic, on (B, S, H, hd) f32
    with H == KV: scores and P V through ``tf32_mm``, softmax in f32."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    s = tf32_mm(qt, kt.transpose(-1, -2), passes, split) * (
        q.shape[-1] ** -0.5)
    sq, sk = s.shape[-2:]
    keep = (torch.arange(sq)[:, None] + (sk - sq)) >= torch.arange(sk)
    s = torch.where(keep, s, torch.tensor(-1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = tf32_mm(p, vt, passes, split) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -10, 3.0], dtype=torch.float32)
    # ties go away from zero; exact values stay
    assert tf32(x).tolist() == [1 + 2 ** -10, 1 + 2 * 2 ** -10,
                                -(1 + 2 ** -10), 1 + 2 ** -10, 3.0]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000, dtype=np.float32))
    assert not (tf32(y).view(torch.int32) & 0x1FFF).any()
    assert ((tf32(y) - y).abs() <= y.abs() * 2 ** -11).all()
    # toward zero: never larger in magnitude, within one TF32 unit
    z = tf32_toward_zero(y)
    assert (z.abs() <= y.abs()).all()
    assert ((z - y).abs() < y.abs() * 2 ** -10).all()


@pytest.mark.parametrize("split", list(SPLITS))
def test_split_parts_sum_to_the_operand(split):
    """big + small is exact in TF32 and within 2^-22 of the f32 value."""
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(
        10000, dtype=np.float32))
    big, small = SPLITS[split](y)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (big.double() + small.double() - y.double()).abs()
    assert (err <= y.abs().double() * 2 ** -22).all()


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("seed", range(3))
def test_three_tf32_passes_hold_the_f32_tolerance(seed, split):
    """The tensor-core kernel's arithmetic: at (1, 128, 2 / 2, 128) causal,
    Q K^T and P V in three TF32 passes are within f32's 2e-5 of the f64
    attention, with the kernel's split and with both parts rounded to
    nearest; one pass is not."""
    (q, k, v), _ = inputs(seed, 1, 128, 128, 2, 2, 128, "float32")
    truth = attention_plain(q.double(), k.double(), v.double())
    err = {n: float((tf32_attention(q, k, v, n, split).double() - truth)
                    .abs().max()) for n in (1, 3)}
    assert err[3] <= TOLS["float32"], err
    assert err[1] > TOLS["float32"], err
