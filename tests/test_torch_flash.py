"""The port's FlashAttention (K6) plain version against the JAX package's
Pallas kernel (interpret mode on the CPU) and its jnp oracle, on the same
seeded inputs; the wrapper's checks.  The CUDA kernel itself is held
against the plain version in ``tests/test_torch_gpu.py`` on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.kernels.ref import attention_ref
from repro_torch.kernels import flash_attention as fa

_SHAPES = [  # tests/test_kernels.py's sweep
    (1, 2, 2, 128, 32, True),
    (2, 4, 2, 128, 64, True),
    (1, 8, 1, 256, 32, True),  # MQA
    (2, 2, 2, 128, 32, False),
    (1, 4, 4, 64, 16, True),
]


def _inputs(b, h, hkv, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, lq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, lk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, lk, d)).astype(np.float32))


def _float64_attention(q, k, v, causal):
    """The attention of fp32 inputs computed in float64 with numpy: an
    oracle that neither framework's fp32 kernels enter."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    rep = q.shape[1] // k.shape[1]
    k, v = np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("b,h,hkv,l,d,causal", _SHAPES)
def test_plain_matches_pallas_and_oracle(b, h, hkv, l, d, causal):
    """The plain version against the Pallas kernel and its jnp oracle, each
    of the three first against a float64 oracle at the same tolerance, so
    that a result that moves names its side (each agrees with float64 to
    about 7e-7 here)."""
    q, k, v = _inputs(b, h, hkv, l, l, d, b * 100 + h + l)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    pallas = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=64,
                                  block_k=64))
    oracle = np.asarray(attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal))
    exact = _float64_attention(q, k, v, causal)
    for name, out in (("the port's plain version", got), ("the Pallas kernel", pallas),
                      ("the jnp oracle", oracle)):
        np.testing.assert_allclose(out, exact, rtol=2e-5, atol=2e-5,
                                   err_msg=f"{name} against float64")
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)


def test_plain_bf16_matches_pallas():
    rng = np.random.default_rng(7)
    qkv = [jnp.asarray(rng.normal(size=(1, 2, 128, 32)), dtype=jnp.bfloat16) for _ in range(3)]
    want = jax_flash(*qkv, causal=True, block_q=64, block_k=64)
    got = fa.flash_attention(
        *(torch.from_numpy(np.array(x, dtype=np.float32)).to(torch.bfloat16) for x in qkv),
        causal=True,
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_plain_matches_pallas_with_uneven_blocks():
    q, k, v = _inputs(1, 2, 2, 256, 256, 32, 9)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True).numpy()
    for bq, bk in [(64, 128), (128, 64)]:
        want = jax_flash(*map(jnp.asarray, (q, k, v)), causal=True, block_q=bq, block_k=bk)
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("lq,lk", [(200, 200), (77, 131)])
def test_plain_ragged_lengths_match_oracle(lq, lk):
    """Lengths that no block size divides (the Pallas kernel refuses them;
    the port's kernel masks the ragged tile): causal only with Lq == Lk."""
    causal = lq == lk
    q, k, v = _inputs(2, 4, 2, lq, lk, 64, lq + lk)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    want = attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_causal_needs_equal_lengths():
    """The kernel's causal mask is aligned at position 0 (the Pallas
    kernel's), the oracle's at the end: they part when Lq != Lk, so the
    wrapper refuses it."""
    q, k, v = map(torch.from_numpy, _inputs(1, 2, 2, 64, 128, 32, 0))
    with pytest.raises(ValueError, match="Lq == Lk"):
        fa.flash_attention(q, k, v, causal=True)
    out = fa.flash_attention(q, k, v, causal=False)
    assert out.shape == (1, 2, 64, 32)


@pytest.mark.parametrize(
    "shapes,dtype,match",
    [
        # D = 24 was refused; the port now takes any D up to 256 (padded on
        # the card), so this case is computed and held against the JAX kernel
        (((1, 2, 8, 24), (1, 2, 8, 24)), torch.float32, None),
        (((1, 2, 8, 272), (1, 2, 8, 272)), torch.float32, r"outside \[1, 256\]"),
        (((1, 3, 8, 32), (1, 2, 8, 32)), torch.float32, "not a multiple"),
        (((1, 2, 8, 32), (1, 2, 8, 16)), torch.float32, "do not fit"),
        (((1, 2, 8, 32), (1, 2, 0, 32)), torch.float32, "at least one key"),
        (((1, 2, 8, 32), (1, 2, 8, 32)), torch.float16, "float32 or bfloat16"),
    ],
)
def test_wrapper_rejects(shapes, dtype, match):
    if match is None:
        q, k, v = _inputs(*shapes[0][:2], shapes[1][1], shapes[0][2], shapes[1][2],
                          shapes[0][3], 24)
        got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False).numpy()
        want = jax_flash(*map(jnp.asarray, (q, k, v)), causal=False, block_q=8, block_k=8)
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
        return
    q = torch.zeros(shapes[0], dtype=dtype)
    k = torch.zeros(shapes[1], dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        fa.flash_attention(q, k, k, causal=False)


@pytest.mark.parametrize("d,dp", [(1, 16), (8, 16), (16, 16), (24, 32), (40, 48), (72, 80),
                                  (250, 256), (256, 256)])
def test_padded_head_dim(d, dp):
    """The head dim the kernels run D at: the next multiple of 16; above 256
    no kernel holds it."""
    assert fa.padded_head_dim(d) == dp
    assert fa.kernel_variant(torch.bfloat16, dp) in fa.VARIANTS
    t = torch.arange(3 * d, dtype=torch.float32).reshape(3, d)
    padded = fa.pad_head_dim(t, dp)
    assert padded.shape == (3, dp) and torch.equal(padded[:, :d], t)
    assert not padded[:, d:].any() and (padded is t) == (d == dp)
    for bad in (0, 257, 272):
        with pytest.raises(ValueError, match="outside"):
            fa.padded_head_dim(bad)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_padded_head_dim_matches_pallas(dtype, tol, causal):
    """D = 40 with GQA (4 query heads on 2 kv heads): the card's path, q, k
    and v zero-padded to 48, the plain version at scale 1/sqrt(40), the
    output cropped, and the plain version at D = 40 both equal the Pallas
    kernel in interpret mode (which takes any D)."""
    q, k, v = _inputs(2, 4, 2, 128, 128, 40, 40)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)
                  for a in (jq, jk, jv))
    dp = fa.padded_head_dim(40)
    padded = fa.flash_attention_ref(*(fa.pad_head_dim(t, dp) for t in (tq, tk, tv)),
                                    causal=causal, scale=1.0 / np.sqrt(40))[..., :40]
    plain = fa.flash_attention(tq, tk, tv, causal=causal)
    for got in (padded, plain):
        assert got.dtype == dtype and got.shape == (2, 4, 128, 40)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    fa.reset_launches()
    q, k, v = map(torch.from_numpy, _inputs(1, 2, 2, 64, 64, 16, 1))
    fa.flash_attention(q, k, v)
    assert fa.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("d", list(range(16, fa.MAX_HEAD_DIM + 1, 16)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_variant_by_dtype_and_head_dim(dtype, d):
    """fp32 stays on the CUDA cores (no TF32); bf16 takes wgmma and TMA at
    D = 64, 80 and 128 and mma.sync at every other head dim."""
    got = fa.kernel_variant(dtype, d)
    assert got in fa.VARIANTS
    if dtype == torch.float32:
        assert got == "fp32_cuda_cores"
    else:
        assert got == ("bf16_wgmma" if d in (64, 80, 128) else "bf16_mma_sync")


@pytest.mark.parametrize("dtype,d,err", [
    (torch.float16, 64, TypeError), (torch.float64, 128, TypeError),
    (torch.bfloat16, 24, ValueError), (torch.bfloat16, 272, ValueError),
    (torch.float32, 0, ValueError),
])
def test_kernel_variant_rejects(dtype, d, err):
    with pytest.raises(err):
        fa.kernel_variant(dtype, d)


@pytest.mark.parametrize("d", list(range(16, fa.MAX_HEAD_DIM + 1, 16)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_variant_by_dtype_and_head_dim(dtype, d):
    """The backward takes the forward's route: fp32 on the CUDA cores, bf16
    with wgmma and TMA at D = 64, 80 and 128 (a key-tile and a query-tile
    kernel), bf16 with mma.sync at every other head dim."""
    got = fa.bwd_kernel_variant(dtype, d)
    assert got in fa.VARIANTS and got == fa.kernel_variant(dtype, d)
    if dtype == torch.float32:
        assert got == "fp32_cuda_cores"
    else:
        assert got == ("bf16_wgmma" if d in (64, 80, 128) else "bf16_mma_sync")


@pytest.mark.parametrize("dtype,d,err", [
    (torch.float16, 64, TypeError), (torch.float64, 128, TypeError),
    (torch.bfloat16, 24, ValueError), (torch.bfloat16, 272, ValueError),
    (torch.float32, 0, ValueError),
])
def test_bwd_kernel_variant_rejects(dtype, d, err):
    with pytest.raises(err):
        fa.bwd_kernel_variant(dtype, d)


@pytest.mark.parametrize("d", [65, 72, 79, 80])
def test_head_dims_65_to_80_take_the_wgmma_route(d):
    """A bf16 head dim from 65 to 80 (72, say) runs padded to 80, and 80
    takes the wgmma kernels forward and backward: those head dims share the
    route of hubert-xlarge's and Zamba2's 80."""
    assert fa.padded_head_dim(d) == 80
    assert fa.kernel_variant(torch.bfloat16, fa.padded_head_dim(d)) == "bf16_wgmma"
    assert fa.bwd_kernel_variant(torch.bfloat16, fa.padded_head_dim(d)) == "bf16_wgmma"


def test_olmo_attention_takes_the_wgmma_kernel():
    """OLMo-1B's heads (128) in bf16 reach the wgmma kernel; its fp32 parity
    path stays on the CUDA cores."""
    from repro_torch.configs import get_config

    hd = get_config("olmo-1b").hd
    assert fa.kernel_variant(torch.bfloat16, hd) == "bf16_wgmma"
    assert fa.kernel_variant(torch.float32, hd) == "fp32_cuda_cores"


# ---- the backward -------------------------------------------------------------
@pytest.mark.parametrize("d", [16, 40])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_bwd_ref_matches_jax_vjp_of_sdpa(causal, d):
    """The plain backward from the forward's o and lse against ``jax.vjp``
    of the JAX package's ``_sdpa`` (what it differentiates; it has no
    backward kernel), GQA 4 query heads on 2 kv heads, fp32 to 2e-5."""
    import jax

    from repro.models import layers as jlayers

    q, k, v = _inputs(2, 4, 2, 96, 96, d, d + causal)
    do = np.random.default_rng(d).normal(size=q.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jlayers._sdpa(a, b, c, causal, None),
                       *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_attention_ref_lse(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=2e-5, atol=2e-5)
    got = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fn_gradcheck(causal):
    """``torch.autograd.gradcheck`` in float64 through ``FlashAttentionFn``
    on the CPU (the plain forward with lse, the plain backward), GQA 4:2."""
    rng = np.random.default_rng(int(causal))
    q, k, v = (torch.from_numpy(rng.normal(size=s)).requires_grad_(True)
               for s in ((1, 4, 9, 8), (1, 2, 9, 8), (1, 2, 9, 8)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.FlashAttentionFn.apply(a, b, c, causal), (q, k, v))


def test_flash_attention_takes_the_function_only_for_gradients():
    """With an input that requires grad, ``flash_attention`` is
    ``FlashAttentionFn`` (whose gradients equal autograd of the plain
    version); without one, or under ``no_grad``, the plain forward; the
    CPU counts no launch either way."""
    fa.reset_launches()
    q, k, v = map(torch.from_numpy, _inputs(2, 4, 2, 50, 50, 24, 3))
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 4, 50, 24)).astype(np.float32))
    plain = fa.flash_attention(q, k, v)
    assert plain.grad_fn is None
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_ref):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, causal=True)
        if fn is fa.flash_attention:
            assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
            assert torch.equal(out.detach(), plain)
            with torch.no_grad():
                assert fa.flash_attention(*leaves).grad_fn is None
        (out * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for g, want in zip(*grads):
        torch.testing.assert_close(g, want, rtol=2e-5, atol=2e-5)
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}


@pytest.mark.parametrize("dp,chunk", [(16, 16), (48, 48), (128, 128), (144, 80), (240, 128),
                                      (256, 128)])
def test_bwd_chunk(dp, chunk):
    """The backward accumulates at most 128 head-dim columns a block: a
    larger D runs in the fewest chunks, each a multiple of 16 that covers D."""
    got = fa.bwd_chunk(dp)
    assert got == chunk and got % 16 == 0 and got <= fa.BWD_CHUNK
    n = -(-dp // got)
    assert n == -(-dp // fa.BWD_CHUNK) and (n - 1) * got < dp
