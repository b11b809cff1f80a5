"""The port's cost pass (``repro_torch.launch.hlo_costs``) and the kernels'
cost formulas and fake branch (``repro_torch.kernels.costs``).

  · the reference's ``tests/test_hlo_costs.py`` functions, run through
    the JAX ``hlo_costs.analyze`` of their compiled HLO and through the
    port's cost pass on the same functions in torch: equal FLOPs (and,
    for the lone f32 product, equal bytes);
  · argument, peak, temporary and output bytes of a toy function whose
    intermediates are known, exactly;
  · collectives: a copy between devices goes to the sender, by tag and
    by link (host = device index // 8);
  · the four kernel formulas at ``PERF.md``'s shapes (17.2 G for K3′,
    2.68 GFLOP and 176,168,960 B for K2, 43.0 G for the flash backward,
    336,068,608 B in f32 and 168,296,448 B in bf16, 306,200,576 B for
    the wkv backward);
  · the fake branch: fake inputs allocate the outputs (and the wkv
    backward's scratch, sized from its source) and report, launch
    nothing and leave ``launches`` alone; bf16 into
    ``flash_attention_bwd`` reports bf16 bytes; and the kernels' limits
    hold (f16 into ``flash_attention_bwd`` raises); a real CPU tensor
    still takes the plain version in every wrapper.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.launch import hlo_costs as jcosts
from repro_torch.kernels import costs as kcosts
from repro_torch.kernels.flash_attention import kernel as FA
from repro_torch.kernels.flash_attention.ref import attention_plain
from repro_torch.kernels.wkv6 import kernel as W
from repro_torch.launch.hlo_costs import analyze


def _jax_costs(f, *specs):
    return jcosts.analyze(jax.jit(f).lower(*specs).compile().as_text())


def _jax_flops(f, *specs) -> float:
    return _jax_costs(f, *specs).flops


def test_scan_flops_exact():
    def jf(w, x):
        def body(c, wi):
            return jnp.tanh(c @ wi), None
        return jax.lax.scan(body, x, w)[0].sum()

    def tf(w, x):
        for wi in w:
            x = torch.tanh(x @ wi)
        return x.sum()

    want = _jax_flops(jf, jax.ShapeDtypeStruct((8, 64, 64), jnp.float32),
                      jax.ShapeDtypeStruct((16, 64), jnp.float32))
    _, cp = analyze(tf, torch.zeros(8, 64, 64), torch.zeros(16, 64))
    assert cp.costs[torch.device("cpu")].flops == want == 8 * 2 * 16 * 64 * 64


def test_nested_scan_multiplies():
    def jf(w, x):
        def outer(c, wi):
            def inner(ci, _):
                return jnp.tanh(ci @ wi), None
            return jax.lax.scan(inner, c, None, length=3)[0], None
        return jax.lax.scan(outer, x, w)[0].sum()

    def tf(w, x):
        for wi in w:
            for _ in range(3):
                x = torch.tanh(x @ wi)
        return x.sum()

    want = _jax_flops(jf, jax.ShapeDtypeStruct((4, 32, 32), jnp.float32),
                      jax.ShapeDtypeStruct((8, 32), jnp.float32))
    _, cp = analyze(tf, torch.zeros(4, 32, 32), torch.zeros(8, 32))
    assert cp.costs[torch.device("cpu")].flops == want == \
        4 * 3 * 2 * 8 * 32 * 32


def test_dot_only_flops():
    want = _jax_flops(lambda a, b: a @ b,
                      jax.ShapeDtypeStruct((128, 256), jnp.bfloat16),
                      jax.ShapeDtypeStruct((256, 64), jnp.bfloat16))
    _, cp = analyze(lambda a, b: a @ b,
                    torch.zeros(128, 256, dtype=torch.bfloat16),
                    torch.zeros(256, 64, dtype=torch.bfloat16))
    c = cp.costs[torch.device("cpu")]
    assert c.flops == want == 2 * 128 * 256 * 64
    assert c.bytes == (128 * 256 + 256 * 64 + 128 * 64) * 2
    # bytes against the reference's, in f32: XLA on the CPU computes a
    # bf16 dot in f32, so its HLO's dot moves f32 operands
    want = _jax_costs(lambda a, b: a @ b,
                      jax.ShapeDtypeStruct((128, 256), jnp.float32),
                      jax.ShapeDtypeStruct((256, 64), jnp.float32))
    _, cp = analyze(lambda a, b: a @ b, torch.zeros(128, 256),
                    torch.zeros(256, 64))
    c = cp.costs[torch.device("cpu")]
    assert c.bytes_by_op == {"product": want.bytes_by_op["dot"]}
    assert c.bytes == want.bytes == (128 * 256 + 256 * 64 + 128 * 64) * 4


def test_peak_and_temporary_bytes_exact():
    """a (2, 1024) and w (1024, 256) f32 in; y = a @ w (2 KiB) and z = y *
    2 (2 KiB) live together, y is freed, sin(z) (2 KiB) is made beside z
    and its transpose copied out (2 KiB) beside both: peak args + 6 KiB,
    output 2 KiB, temporary 4 KiB."""
    def f(a, w):
        y = a @ w
        z = y * 2
        del y
        return torch.sin(z).t().contiguous()

    with FakeTensorMode():
        a = torch.empty(2, 1024, device="cpu:2")
        w = torch.empty(1024, 256, device="cpu:2")
        _, cp = analyze(f, a, w)
    m = cp.memory[torch.device("cpu", 2)]
    arg = 2 * 1024 * 4 + 1024 * 256 * 4
    assert (m.arg, m.peak, m.out, m.temp) == (arg, arg + 6144, 2048, 4096)
    c = cp.costs[torch.device("cpu", 2)]
    assert c.bytes_by_op == {"product": arg + 2048, "copy": 4096}


def test_collectives_go_to_the_sender_by_tag_and_link():
    from repro_torch.parallelism.tensor import fan_out, row_sum
    devs = [torch.device("cpu", i) for i in (0, 1, 8)]
    with FakeTensorMode():
        x = torch.empty(16, 4, device=devs[0])
        parts = [torch.empty(16, 4, device=d) for d in devs]
        _, cp = analyze(lambda x, p: (fan_out(x, devs), row_sum(p, devs)),
                        x, parts)
    c0 = cp.costs[devs[0]]
    # fan_out: 2 copies from cpu:0; row_sum's result copied out likewise
    assert c0.coll_bytes == {"fan_out": 2 * 256, "row_sum": 2 * 256}
    assert c0.link_bytes == {"intra": 2 * 256, "inter": 2 * 256}
    # row_sum's partials are sent to the first device by their holders
    assert cp.costs[devs[2]].coll_bytes == {"row_sum": 256}
    assert cp.costs[devs[2]].link_bytes["inter"] == 256


@pytest.mark.parametrize("fn,args,flops,nbytes", [
    (FA.flash_cost, (8, 512, 512, 32, 8, 128, True), 17_213_423_616,
     167_772_160),
    (FA.flash_bwd_cost, (8, 512, 512, 32, 8, 128, True), 43_033_559_040,
     336_068_608),
    (FA.flash_bwd_cost, (8, 512, 512, 32, 8, 128, True, 2), 43_033_559_040,
     168_296_448),
    (W.wkv6_cost, (8, 512, 32, 64), 2_684_354_560, 176_168_960),
    (W.wkv6_bwd_cost, (8, 512, 32, 64), 6_442_450_944, 306_200_576),
])
def test_kernel_formulas_at_the_perf_table_shapes(fn, args, flops, nbytes):
    assert fn(*args) == (flops, nbytes)
    assert round(flops / 1e9, 1) in (17.2, 43.0, 2.7, 6.4)


def test_flash_cost_counts_only_the_pairs_it_attends():
    # right-aligned causal mask: query i sees keys j <= i + sk - sq
    for sq, sk in ((1, 1), (7, 7), (5, 9), (1, 300)):
        want = sum(min(sk, i + sk - sq + 1) for i in range(sq))
        assert FA.causal_pairs(sq, sk, True) == want
    assert FA.causal_pairs(100, 300, False) == 30_000


def _fake_calls():
    """Every kernel path on fake inputs: forward with a gradient (both
    kernels through their autograd functions) and without."""
    q = torch.empty(2, 64, 4, 32, device="cpu:5", requires_grad=True)
    kv = torch.empty(2, 64, 2, 32, device="cpu:5", requires_grad=True)
    r = torch.empty(2, 40, 2, 16, device="cpu:5", requires_grad=True)
    u = torch.empty(2, 16, device="cpu:5", requires_grad=True)
    s0 = torch.empty(2, 2, 16, 16, device="cpu:5")
    o = FA.flash_attention(q, kv, kv)
    y, s1 = W.wkv6(r, r, r, r, u, s0)
    grads = torch.autograd.grad(o.sum() + y.sum() + s1.sum(), [q, kv, r, u])
    with torch.no_grad():
        o2 = FA.flash_attention(q, kv, kv, causal=False)
        y2, _ = W.wkv6(r, r, r, r, u, s0)
    return o, y, s1, grads, o2, y2


def test_fake_inputs_report_and_launch_nothing():
    before = (FA.flash_attention.launches, FA.flash_attention_bwd.launches,
              W.wkv6.launches, W.wkv6_bwd.launches)
    with FakeTensorMode():
        (o, y, s1, grads, o2, y2), cp = analyze(_fake_calls)
    assert (FA.flash_attention.launches, FA.flash_attention_bwd.launches,
            W.wkv6.launches, W.wkv6_bwd.launches) == before
    assert tuple(o.shape) == tuple(o2.shape) == (2, 64, 4, 32)
    assert tuple(y.shape) == (2, 40, 2, 16) and tuple(s1.shape) == (2, 2, 16,
                                                                     16)
    assert [tuple(g.shape) for g in grads] == [(2, 64, 4, 32), (2, 64, 2, 32),
                                               (2, 40, 2, 16), (2, 16)]
    k = cp.kernels
    assert {n: v["calls"] for n, v in k.items()} == {
        "flash_attention": 2, "flash_attention_bwd": 1, "wkv6": 2,
        "wkv6_bwd": 1}
    f_fwd = FA.flash_cost(2, 64, 64, 4, 2, 32, True, 4, True)
    f_full = FA.flash_cost(2, 64, 64, 4, 2, 32, False)
    assert k["flash_attention"]["flops"] == f_fwd[0] + f_full[0]
    assert k["flash_attention_bwd"]["bytes"] == FA.flash_bwd_cost(
        2, 64, 64, 4, 2, 32, True)[1]
    assert k["wkv6_bwd"]["bytes"] == W.wkv6_bwd_cost(2, 40, 2, 16, True)[1]
    assert kcosts.PASSES == []
    dev = torch.device("cpu", 5)
    assert set(cp.costs) == {dev}
    assert cp.costs[dev].flops == sum(v["flops"] for v in k.values())


def test_wkv_backward_scratch_is_sized_from_the_kernel_source():
    """The backward's scratch (a state before each chunk of C tokens) is
    sized by ``bwd_scratch_floats`` alone, C read from ``wkv6_bwd.cu``:
    a fake call holds it, beside ``du``'s per-row partials, as its only
    temporaries."""
    assert W.bwd_chunk(W.BWD_SOURCE.read_text()) == 32
    assert W.bwd_scratch_floats(8, 512, 32, 64) * 4 == 67_108_864
    b, s, h, hs = 2, 40, 2, 16
    with FakeTensorMode():
        x = torch.empty(b, s, h, hs, device="cpu:3")
        u = torch.empty(h, hs, device="cpu:3")
        s0 = torch.empty(b, h, hs, hs, device="cpu:3")
        _, cp = analyze(W.wkv6_bwd, x, x, x, x, u, s0, x)
    m = cp.memory[torch.device("cpu", 3)]
    assert m.out == 4 * (4 * b * s * h * hs + h * hs)    # dr dk dv dw, du
    assert m.temp == 4 * (b * h * hs + b * h * 2 * hs * hs) == 4 * (
        b * h * hs + W.bwd_scratch_floats(b, s, h, hs))


def test_fake_bf16_backward_reports_bf16_bytes():
    """bf16 into flash_attention_bwd: bf16 gradients, and the call's bytes
    at 2 an element (the log-sum-exp f32) by flash_bwd_cost."""
    with FakeTensorMode():
        q = torch.empty(1, 64, 4, 32, device="cpu:1", dtype=torch.bfloat16)
        kv = torch.empty(1, 64, 2, 32, device="cpu:1", dtype=torch.bfloat16)
        lse = torch.empty(1, 4, 64, device="cpu:1")
        grads, cp = analyze(FA.flash_attention_bwd, q, kv, kv, q, lse, q)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [tuple(g.shape) for g in grads] == [(1, 64, 4, 32),
                                               (1, 64, 2, 32),
                                               (1, 64, 2, 32)]
    k = cp.kernels["flash_attention_bwd"]
    assert (k["calls"], k["flops"], k["bytes"]) == (
        1, *FA.flash_bwd_cost(1, 64, 64, 4, 2, 32, True, 2))
    assert k["bytes"] == 2 * 32 * (4 * 64 * 4 + 4 * 64 * 2) + 4 * 4 * 64


def test_fake_inputs_keep_the_kernels_limits():
    with FakeTensorMode():
        q = torch.empty(1, 64, 2, 32, device="cpu:1", dtype=torch.float16)
        lse = torch.empty(1, 2, 64, device="cpu:1")
        with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
            FA.flash_attention_bwd(q, q, q, q, lse, q)
        with pytest.raises(ValueError, match="head size 24"):
            FA.flash_attention(*(torch.empty(1, 8, 2, 24, device="cpu:1"),)
                               * 3)
        with pytest.raises(ValueError, match="Sq = 9 > Sk = 8"):
            FA.flash_attention(torch.empty(1, 9, 2, 32), *(
                torch.empty(1, 8, 2, 32),) * 2)
        r = torch.empty(1, 4, 1, 16)
        with pytest.raises(ValueError, match="16-byte boundary"):
            W.wkv6(r, r, r, torch.empty(65)[1:].view(1, 4, 1, 16), r[0, 0],
                   torch.empty(1, 1, 16, 16))


def test_real_cpu_tensors_take_the_plain_versions():
    """A real CPU tensor never takes the fake branch: every wrapper runs
    its plain version, reports no kernel and counts no launch; the
    kernels' own entries refuse it."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 2, 16, generator=g)
    kv = torch.randn(1, 16, 1, 16, generator=g)
    r = torch.randn(1, 8, 1, 16, generator=g)
    wlog = -torch.rand(1, 8, 1, 16, generator=g)
    u, s0 = torch.randn(1, 16, generator=g), torch.zeros(1, 1, 16, 16)
    before = (FA.flash_attention.launches, W.wkv6.launches)

    def run():
        return (FA.flash_attention(q, kv, kv), W.wkv6(r, r, r, wlog, u, s0))

    (o, (y, s1)), cp = analyze(run)
    assert cp.kernels == {}
    assert (FA.flash_attention.launches, W.wkv6.launches) == before
    torch.testing.assert_close(o, attention_plain(q, kv, kv), rtol=0, atol=0)
    want = W.wkv6_plain(r, r, r, wlog, u, s0)
    torch.testing.assert_close(y, want[0], rtol=0, atol=0)
    torch.testing.assert_close(s1, want[1], rtol=0, atol=0)
    for call in (lambda: FA._flash_kernel(q, kv, kv, True, False),
                 lambda: FA.flash_attention_bwd(q, kv, kv, q, q[0, :, :, 0],
                                                q),
                 lambda: W._wkv6_kernel(r, r, r, wlog, u, s0),
                 lambda: W.wkv6_bwd(r, r, r, wlog, u, s0, r)):
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            call()
    assert np.isfinite(o.numpy()).all()
