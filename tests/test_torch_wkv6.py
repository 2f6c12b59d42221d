"""The port's wkv6 recurrence (K7) plain version against the JAX package's
Pallas kernel (interpret mode on the CPU), its jnp oracle and the model's
chunked scan ``repro.models.rwkv6._wkv_scan``, on the same seeded inputs;
the state carried from one call to the next; the wrapper's checks.  The
backward's plain version (K7b's, ``wkv6_bwd_ref``) against ``jax.vjp`` of
the oracle and of the scan, and ``Wkv6Fn`` by a float64 gradcheck.  The
CUDA kernels themselves are held against the plain versions in
``tests/test_torch_gpu.py`` on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import wkv6_pallas
from repro.kernels.wkv6 import wkv6_ref as jax_wkv6_ref
from repro.models.rwkv6 import _wkv_scan
from repro_torch.kernels import wkv6 as wk

_TOL = dict(rtol=2e-4, atol=2e-4)  # the JAX package's wkv6 kernel tests


def _inputs(b, l, h, hd, seed, s0_scale=0.0):
    """r, k, v, w, u, s0 as ``tests/test_kernels.py`` draws them: k scaled
    by 0.3, w in (0.6, 0.999), u != 0."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, l, h, hd)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.6, 0.999, size=(b, l, h, hd)).astype(np.float32)
    u = (rng.normal(size=(h, hd)) * 0.1).astype(np.float32)
    s0 = (rng.normal(size=(b, h, hd, hd)) * s0_scale).astype(np.float32)
    return r, k * np.float32(0.3), v, w, u, s0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("bh,l,hd,chunk", [(2, 32, 8, 16), (4, 64, 16, 64), (1, 128, 32, 32)])
def test_plain_matches_pallas_and_oracle(bh, l, hd, chunk):
    """The JAX kernel's [BH, L, hd] layout is the port's [1, L, H, hd] with
    H = BH, and its per-row u the port's per-head u."""
    r, k, v, w, u, _ = _inputs(1, l, bh, hd, bh * 100 + l)
    y, s = wk.wkv6_ref(*_t(r, k, v, w, u))
    flat = [jnp.asarray(a[0].transpose(1, 0, 2)) for a in (r, k, v, w)]
    pallas = wkv6_pallas(*flat, jnp.asarray(u), chunk=chunk)
    oracle = jax_wkv6_ref(*flat, jnp.asarray(u))
    got = y[0].transpose(0, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), **_TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **_TOL)
    assert s.shape == (1, bh, hd, hd)


@pytest.mark.parametrize("b,l,h,hd,chunk,unroll", [
    (2, 64, 3, 16, 16, 4),
    (1, 50, 2, 16, 16, 8),  # L no multiple of the chunk: the scan pads
    (2, 1, 4, 32, 1, 1),  # a decode step
])
def test_plain_matches_model_scan_with_state(b, l, h, hd, chunk, unroll):
    r, k, v, w, u, s0 = _inputs(b, l, h, hd, l + hd, s0_scale=0.5)
    want_y, want_s = _wkv_scan(*map(jnp.asarray, (r, k, v, w, u, s0)), chunk=chunk,
                               unroll=unroll)
    for fn in (wk.wkv6_ref, wk.wkv6):
        y, s = fn(*_t(r, k, v, w, u, s0))
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **_TOL)


@pytest.mark.parametrize("h,l,hd", [(2, 24, 8), (3, 40, 16), (1, 9, 32)])
def test_plain_gradients_match_jax_grad(h, l, hd):
    """On the CPU the port's ``wkv6`` (its plain version) differentiates:
    the gradients of sum(y * g) with respect to r, k, v, w and u equal
    ``jax.grad`` of the JAX package's ``wkv6_ref`` on the same seeded
    inputs and cotangent g, in fp32 to the kernel tests' 2e-4 (sums over
    the sequence taken in another order), through ``Wkv6Fn`` and its plain
    backward."""
    import jax

    r, k, v, w, u, _ = _inputs(1, l, h, hd, 11 * h + l)
    g = np.random.default_rng(l).normal(size=r.shape).astype(np.float32)
    flat = [jnp.asarray(a[0].transpose(1, 0, 2)) for a in (r, k, v, w, g)]

    def loss(r_, k_, v_, w_, u_):
        return jnp.sum(jax_wkv6_ref(r_, k_, v_, w_, u_) * flat[4])

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*flat[:4], jnp.asarray(u))
    leaves = [t.requires_grad_(True) for t in _t(r, k, v, w, u)]
    y, _ = wk.wkv6(*leaves)
    (y * torch.from_numpy(g)).sum().backward()
    for name, leaf, wnt in zip("rkvwu", leaves, want):
        got = leaf.grad if name == "u" else leaf.grad[0].transpose(0, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(wnt), **_TOL, err_msg=name)


def test_state_carries_across_calls():
    """One pass over L equals two passes with the state carried, the second
    updating it in place as a decode step does."""
    r, k, v, w, u, s0 = _t(*_inputs(2, 96, 2, 16, 3, s0_scale=0.2))
    y, s = wk.wkv6(r, k, v, w, u, s0)
    y1, s1 = wk.wkv6(r[:, :40], k[:, :40], v[:, :40], w[:, :40], u, s0)
    buf = s1.clone()
    y2, s2 = wk.wkv6(r[:, 40:], k[:, 40:], v[:, 40:], w[:, 40:], u, buf, state_out=buf)
    assert s2 is buf
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(buf.numpy(), s.numpy(), rtol=1e-5, atol=1e-5)


def test_zero_state_is_the_default():
    r, k, v, w, u, _ = _t(*_inputs(1, 20, 2, 16, 4))
    y, s = wk.wkv6(r, k, v, w, u)
    y0, s0 = wk.wkv6(r, k, v, w, u, torch.zeros_like(s))
    assert torch.equal(y, y0) and torch.equal(s, s0)


def test_wrapper_reads_strided_views():
    r, k, v, w, u, _ = _t(*_inputs(2, 30, 3, 16, 6))
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)
    y, s = wk.wkv6(r, kt, v, w, u)
    y_want, s_want = wk.wkv6_ref(r, k, v, w, u)
    assert torch.equal(y, y_want) and torch.equal(s, s_want)


def test_wrapper_checks_its_arguments():
    r, k, v, w, u, s0 = _t(*_inputs(2, 8, 2, 16, 7))
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        wk.wkv6(r.double(), k, v, w, u)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        wk.wkv6(r, k, v, w, u.to(torch.int32))
    with pytest.raises(TypeError, match="state must be float32"):
        wk.wkv6(r, k, v, w, u, s0.double())
    with pytest.raises(TypeError, match="state must be float32"):
        wk.wkv6(r, k, v, w, u, state_out=s0.bfloat16())
    with pytest.raises(ValueError, match="differ"):
        wk.wkv6(r, k[:, :4], v, w, u)
    with pytest.raises(ValueError, match=r"\[B, L, H, hd\]"):
        wk.wkv6(r[0], k[0], v[0], w[0], u)
    with pytest.raises(ValueError, match="u must be"):
        wk.wkv6(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="s0 must be"):
        wk.wkv6(r, k, v, w, u, s0[:1])
    with pytest.raises(ValueError, match="state_out must be"):
        wk.wkv6(r, k, v, w, u, state_out=s0[:, :1])
    with pytest.raises(ValueError, match="contiguous"):
        wk.wkv6(r, k, v, w, u, state_out=s0.transpose(2, 3))
    with pytest.raises(ValueError, match="at least one token"):
        wk.wkv6(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u)
    # hd = 8 was refused; the port now takes any hd up to 128 (padded on the
    # card) and computes it, held against the JAX kernel; above 128 it raises
    r8, k8, v8, w8, u8, _ = _inputs(1, 4, 2, 8, 8)
    y8, _ = wk.wkv6(*_t(r8, k8, v8, w8, u8))
    flat = [jnp.asarray(a[0].transpose(1, 0, 2)) for a in (r8, k8, v8, w8)]
    np.testing.assert_allclose(y8[0].transpose(0, 1).numpy(),
                               np.asarray(wkv6_pallas(*flat, jnp.asarray(u8), chunk=4)), **_TOL)
    r9, k9, v9, w9, u9, _ = _t(*_inputs(1, 4, 2, 144, 8))
    with pytest.raises(ValueError, match=r"outside \[1, 128\]"):
        wk.wkv6(r9, k9, v9, w9, u9)
    with pytest.raises(ValueError, match="no kernel for device"):
        wk.wkv6(*(t.to("meta") for t in (r, k, v, w, u)))


def _geometry_fits(hd, jc, p, c):
    """The static_asserts of csrc/wkv6.cu's kernel, with its T = 8 tokens a
    tile: whole column blocks and groups, 16-byte copies of v, float4 row
    groups, a power-of-two P inside a warp, whole warps, a bonus reduction
    within a warp."""
    nt = jc // c * p
    return (hd % jc == 0 and jc % c == 0 and jc % 4 == 0 and c in (2, 4)
            and hd % (4 * p) == 0 and 32 % p == 0 and nt % 32 == 0
            and nt % 8 == 0 and nt // 8 <= 32
            and (8 * c) % p == 0)


@pytest.mark.parametrize("hd", wk.HEAD_DIMS)
def test_launch_geometry_covers_every_head_dim(hd):
    jc, p, c = wk.launch_geometry(hd)
    assert hd % jc == 0 and hd % p == 0 and jc % c == 0
    assert _geometry_fits(hd, jc, p, c)


@pytest.mark.parametrize("hd", wk.HEAD_DIMS)
def test_launch_geometry_partitions_the_state(hd):
    """csrc/wkv6.cu's index arithmetic at hd's geometry: over the hd / JC
    blocks of a head, thread tid holds the C columns of group tid / P and
    the rows 4 (p + P m) + e (p = tid % P), so every state element is held
    by exactly one thread; the reduce-scatter over the P lanes of a column
    group leaves each (token, column) total of a tile with exactly one lane;
    the bonus reduction's lanes of a token fit inside a warp."""
    jc, p, c = wk.launch_geometry(hd)
    nt, t_tile = jc // c * p, 8
    held = np.zeros((hd, hd), dtype=np.int64)
    for by in range(hd // jc):
        for tid in range(nt):
            lane, g = tid % p, tid // p
            j0 = by * jc + g * c
            for m in range(hd // p // 4):
                for e in range(4):
                    held[4 * (lane + p * m) + e, j0:j0 + c] += 1
    assert (held == 1).all()
    kept = np.zeros(t_tile * c, dtype=np.int64)
    for lane in range(p):
        n, o, base = t_tile * c, p // 2, 0
        while o > 0:  # Scatter<N, O>::run
            if lane & o:
                base += n // 2
            n, o = n // 2, o // 2
        kept[base:base + t_tile * c // p] += 1
    assert (kept == 1).all()
    tpt = nt // t_tile
    assert tpt * t_tile == nt and 32 % tpt == 0


@pytest.mark.parametrize("hd", wk.HEAD_DIMS)
def test_launch_geometry_copies_each_tile_word_once(hd):
    """csrc/wkv6.cu's ``Copies`` at hd's geometry: the tile's 16-byte words
    (r, k and w over every row, v over the block's JC columns, 8 tokens),
    dealt out as copy s = tid + NT i, land each at its own offset of a
    stage, every offset of the stage written once."""
    jc, p, c = wk.launch_geometry(hd)
    nt, t_tile, row4, v4 = jc // c * p, 8, hd // 4, jc // 4
    n = 3 * t_tile * row4 + t_tile * v4
    per = -(-n // nt)
    dst = []
    for tid in range(nt):
        for i in range(per):
            s_ = tid + nt * i
            if s_ < 3 * t_tile * row4:
                qq, t, col = s_ // (t_tile * row4), (s_ // row4) % t_tile, s_ % row4
                dst.append(4 * ((qq * t_tile + t) * hd + 4 * col))
            elif s_ < n:
                e = s_ - 3 * t_tile * row4
                dst.append(4 * (3 * t_tile * hd + (e // v4) * jc + 4 * (e % v4)))
    stage_bytes = 4 * (3 * t_tile * hd + t_tile * jc)
    assert sorted(dst) == list(range(0, stage_bytes, 16))


@pytest.mark.parametrize("hd", [8, 24, 144])
def test_launch_geometry_rejects(hd):
    """Above 128 no geometry holds the state: refused.  A head dim below
    that is no multiple of 16 (refused before) runs at the padded dim's
    geometry, which ``launch_geometry`` names."""
    if hd > wk.MAX_HEAD_DIM:
        with pytest.raises(ValueError, match="outside"):
            wk.launch_geometry(hd)
        return
    hp = wk.padded_head_dim(hd)
    assert hp in wk.HEAD_DIMS and hp - 16 < hd < hp
    assert wk.launch_geometry(hd) == wk.launch_geometry(hp)
    assert wk.launch_geometry(hd, 1) == wk.STEP


@pytest.mark.parametrize("hd", [1, 8, 24, 40, 72, 127])
def test_pad_head_dim_keeps_the_function(hd):
    """The card's path at a head dim that is no multiple of 16, run through
    the plain version: inputs padded (r, k, v, u, s0 with zeros, w with
    ones), the recurrence at the padded dim, y and the state cropped, equal
    to the plain version at hd itself (to 1e-5: einsum sums the longer
    padded rows in another order); the padded rows and columns of the final
    state stay exactly zero."""
    r, k, v, w, u, s0 = _t(*_inputs(2, 9, 2, hd, hd, s0_scale=0.5))
    padded = wk.pad_head_dim(r, k, v, w, u, s0)
    hp = wk.padded_head_dim(hd)
    assert all(t.shape[-1] == hp and t.dtype == torch.float32 for t in padded)
    y_p, s_p = wk.wkv6_ref(*padded)
    y, s = wk.wkv6_ref(r, k, v, w, u, s0)
    np.testing.assert_allclose(y_p[..., :hd].numpy(), y.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s_p[..., :hd, :hd].numpy(), s.numpy(), rtol=1e-5, atol=1e-5)
    assert not s_p[..., hd:, :].any() and not s_p[..., :, hd:].any()


@pytest.mark.parametrize("with_state", [False, True])
def test_padded_head_dim_matches_pallas(with_state):
    """hd = 24: the padding path (pad to 32, the plain version, crop) and
    the plain version at hd = 24 against ``wkv6_pallas`` in interpret mode
    from zero, and against the model's ``_wkv_scan`` with a state."""
    b, l, h, hd = 1, 32, 3, 24
    r, k, v, w, u, s0 = _inputs(b, l, h, hd, 24, s0_scale=0.5 if with_state else 0.0)
    tt = _t(r, k, v, w, u, s0)
    y_p, s_p = wk.wkv6_ref(*wk.pad_head_dim(*tt))
    outs = [(y_p[..., :hd], s_p[..., :hd, :hd]), wk.wkv6(*tt)]
    if with_state:
        want_y, want_s = (np.asarray(a) for a in _wkv_scan(
            *map(jnp.asarray, (r, k, v, w, u, s0)), chunk=16, unroll=1))
    else:
        flat = [jnp.asarray(a[0].transpose(1, 0, 2)) for a in (r, k, v, w)]
        want_y = np.asarray(wkv6_pallas(*flat, jnp.asarray(u), chunk=16)).transpose(1, 0, 2)[None]
        want_s = None
    for y, s in outs:
        assert y.shape == (b, l, h, hd) and s.shape == (b, h, hd, hd)
        np.testing.assert_allclose(y.numpy(), want_y, **_TOL)
        if want_s is not None:
            np.testing.assert_allclose(s.numpy(), want_s, **_TOL)


@pytest.mark.parametrize("hd", wk.HEAD_DIMS)
def test_decode_step_takes_its_own_kernel(hd):
    """L = 1 (a decode step) launches the step kernel at every head dim; any
    longer sequence the split kernel's geometry."""
    assert wk.launch_geometry(hd, 1) == wk.STEP == (0, 0, 0)
    assert wk.launch_geometry(hd, 2) == wk.launch_geometry(hd) == wk.launch_geometry(hd, 2048)
    with pytest.raises(ValueError, match="at least one token"):
        wk.launch_geometry(hd, 0)


_NARROW = [torch.bfloat16, torch.float16]
_JNP = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


@pytest.mark.parametrize("dtype", _NARROW, ids=str)
@pytest.mark.parametrize("bh,l,hd,chunk", [(2, 32, 16, 16), (3, 64, 32, 32)])
def test_narrow_inputs_match_pallas(dtype, bh, l, hd, chunk):
    """bf16 and fp16 r, k, v, w, as ``wkv6_pallas`` takes them: widened to
    fp32 inside, y in r's dtype.  The fp32 values before the final rounding
    (r given in fp32, so both return y unrounded) agree to 2e-4; y in r's
    dtype is exactly that value rounded, in both packages, so the two
    narrow results part by at most one rounding step of the narrow type
    (relative 2^-7 for bf16, 2^-10 for fp16)."""
    r, k, v, w, u, _ = _inputs(1, l, bh, hd, bh * 31 + l)
    narrow = [torch.from_numpy(a).to(dtype) for a in (r, k, v, w)]
    wide_r = narrow[0].float()
    tu = torch.from_numpy(u)

    def pallas(*rkvw):
        flat = [jnp.asarray(a[0].float().numpy().transpose(1, 0, 2)).astype(
            jnp.float32 if a.dtype == torch.float32 else _JNP[dtype]) for a in rkvw]
        return np.asarray(wkv6_pallas(*flat, jnp.asarray(u), chunk=chunk).astype(jnp.float32))

    # r in fp32, k, v, w narrow: both widen k, v, w and return fp32 y
    y32, s32 = wk.wkv6(wide_r, *narrow[1:], tu)
    assert y32.dtype == torch.float32 and s32.dtype == torch.float32
    want32 = pallas(wide_r, *narrow[1:])
    np.testing.assert_allclose(y32[0].transpose(0, 1).numpy(), want32, **_TOL)
    # everything narrow: y in r's dtype, the rounding of the fp32 result
    y, s = wk.wkv6(*narrow, tu)
    assert y.dtype == dtype and s.dtype == torch.float32
    assert torch.equal(y, y32.to(dtype)) and torch.equal(s, s32)
    want = pallas(*narrow)
    assert np.array_equal(want, np.asarray(jnp.asarray(want32).astype(_JNP[dtype]).astype(
        jnp.float32)))
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    np.testing.assert_allclose(y[0].transpose(0, 1).float().numpy(), want, rtol=step,
                               atol=_TOL["atol"])
    # the plain version on narrow inputs is the wrapper's CPU path
    y_ref, s_ref = wk.wkv6_ref(*narrow, tu)
    assert torch.equal(y_ref, y) and torch.equal(s_ref, s)


# ---- the backward: wkv6_bwd_ref (K7b's plain version) and Wkv6Fn ----------
def _frac_close(got, want, frac=2e-4, name=""):
    """Within ``frac`` of ``want``'s largest entry (the gradients are sums
    over the sequence and the state's rows or columns, taken in another
    order)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.abs(got - want).max() <= frac * np.abs(want).max() + 1e-30, name


def _cotangents(b, l, h, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, l, h, hd)).astype(np.float32),
            rng.normal(size=(b, h, hd, hd)).astype(np.float32))


@pytest.mark.parametrize("with_ds", [False, True])
@pytest.mark.parametrize("b,l,h,hd,chunk", [
    (2, 37, 3, 16, 16),  # ragged: the scan pads to 48
    (1, 1, 2, 32, 1),  # a single token
    (2, 24, 2, 8, 8),
])
def test_plain_backward_matches_jax_vjp_of_model_scan(b, l, h, hd, chunk, with_ds):
    """``wkv6_bwd_ref`` from a state against ``jax.vjp`` of the model's
    chunked, checkpointed ``_wkv_scan`` with cotangents (dy, dS_final): dr,
    dk, dv, dw, du and ds0, each to 2e-4 of its largest entry."""
    r, k, v, w, u, s0 = _inputs(b, l, h, hd, 7 * l + hd, s0_scale=0.5)
    dy, ds = _cotangents(b, l, h, hd, l)
    ds = ds if with_ds else np.zeros_like(ds)
    _, vjp = jax.vjp(lambda *a: _wkv_scan(*a, chunk=chunk, unroll=1),
                     *map(jnp.asarray, (r, k, v, w, u, s0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    got = wk.wkv6_bwd_ref(*_t(r, k, v, w, u, dy), torch.from_numpy(s0),
                          torch.from_numpy(ds) if with_ds else None)
    for name, g, wnt in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        _frac_close(g.numpy(), wnt, name=name)


@pytest.mark.parametrize("h,l,hd", [(2, 24, 8), (3, 40, 16)])
def test_plain_backward_matches_jax_vjp_of_oracle(h, l, hd):
    """From zero, against ``jax.vjp`` of the JAX package's ``wkv6_ref`` (the
    Pallas kernel's oracle, [BH, L, hd] with per-row u; B = 1, so BH = H)."""
    r, k, v, w, u, _ = _inputs(1, l, h, hd, 3 * h + l)
    dy, _ = _cotangents(1, l, h, hd, hd)
    flat = [jnp.asarray(a[0].transpose(1, 0, 2)) for a in (r, k, v, w, dy)]
    _, vjp = jax.vjp(jax_wkv6_ref, *flat[:4], jnp.asarray(u))
    want = vjp(flat[4])
    got = wk.wkv6_bwd_ref(*_t(r, k, v, w, u, dy))
    for name, g, wnt in zip("rkvw", got, want):
        _frac_close(g[0].transpose(0, 1).numpy(), wnt, name=name)
    _frac_close(got[4].numpy(), want[4], name="u")


def test_plain_backward_underflowing_decay():
    """rwkv6's decay exp(-exp(x)) is exactly 0 in fp32 for x above about
    4.5: the backward recomputes the states forward (it divides by no w), so
    every gradient is finite and equals the JAX package's vjp."""
    b, l, h, hd = 2, 30, 2, 16
    r, k, v, _, u, s0 = _inputs(b, l, h, hd, 5, s0_scale=0.5)
    x = np.random.default_rng(6).uniform(-3, 7, size=(b, l, h, hd))
    w = np.exp(-np.exp(x)).astype(np.float32)
    assert (w == 0).any()
    dy, ds = _cotangents(b, l, h, hd, 6)
    _, vjp = jax.vjp(lambda *a: _wkv_scan(*a, chunk=8, unroll=1),
                     *map(jnp.asarray, (r, k, v, w, u, s0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    got = wk.wkv6_bwd_ref(*_t(r, k, v, w, u, dy), torch.from_numpy(s0), torch.from_numpy(ds))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for name, g, wnt in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        _frac_close(g.numpy(), wnt, name=name)


# ---- K7b's chunked algorithm in plain torch (wkv6_bwd_chunked_ref) -------
_C = wk.BWD_CHUNK


@pytest.mark.parametrize("with_s0,with_ds", [(False, False), (True, False), (False, True),
                                             (True, True)])
@pytest.mark.parametrize("hd", [16, 80])
@pytest.mark.parametrize("l", [1, _C - 1, _C, _C + 1, 2 * _C + 3])
def test_chunked_backward_matches_plain_and_jax_vjp(l, hd, with_s0, with_ds):
    """Passes A-C (chunks of 32 tokens, tiles of 8) against the explicit
    reverse recurrence ``wkv6_bwd_ref`` and ``jax.vjp`` of the model's
    ``_wkv_scan``, at lengths around the chunk (L = 1, C - 1, C, C + 1,
    2C + 3), with and without s0 and dS_final: every gradient to 2e-4 of
    its largest entry (sums over the chunks in another order)."""
    b, h = 2, 2
    r, k, v, w, u, s0 = _inputs(b, l, h, hd, l + hd, s0_scale=0.5 if with_s0 else 0.0)
    dy, ds = _cotangents(b, l, h, hd, 2 * l + hd)
    ds = ds if with_ds else np.zeros_like(ds)
    args = (*_t(r, k, v, w, u, dy), torch.from_numpy(s0) if with_s0 else None,
            torch.from_numpy(ds) if with_ds else None)
    got = wk.wkv6_bwd_chunked_ref(*args)
    plain = wk.wkv6_bwd_ref(*args)
    _, vjp = jax.vjp(lambda *a: _wkv_scan(*a, chunk=16, unroll=1),
                     *map(jnp.asarray, (r, k, v, w, u, s0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    for name, g, p, wnt in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, plain, want):
        assert g.dtype == p.dtype and g.shape == p.shape, name
        _frac_close(g.numpy(), p.numpy(), name=name)
        _frac_close(g.numpy(), wnt, name=name)


def test_chunked_backward_underflowing_decay():
    """The underflowing decay of ``test_plain_backward_underflowing_decay``
    over three chunks: the chunks' decay products are formed by multiplying
    w (a 0 gives zeros, no 0/0), so every gradient is finite and equals the
    plain version and the JAX package's vjp."""
    b, l, h, hd = 2, 2 * _C + 3, 2, 16
    r, k, v, _, u, s0 = _inputs(b, l, h, hd, 5, s0_scale=0.5)
    x = np.random.default_rng(6).uniform(-3, 7, size=(b, l, h, hd))
    w = np.exp(-np.exp(x)).astype(np.float32)
    assert (w == 0).any()
    dy, ds = _cotangents(b, l, h, hd, 6)
    args = (*_t(r, k, v, w, u, dy), torch.from_numpy(s0), torch.from_numpy(ds))
    got = wk.wkv6_bwd_chunked_ref(*args)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _, vjp = jax.vjp(lambda *a: _wkv_scan(*a, chunk=8, unroll=1),
                     *map(jnp.asarray, (r, k, v, w, u, s0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    for name, g, p, wnt in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                               wk.wkv6_bwd_ref(*args), want):
        _frac_close(g.numpy(), p.numpy(), name=name)
        _frac_close(g.numpy(), wnt, name=name)


def test_bwd_head_dim_pads_to_a_power_of_two():
    """K7b's widths: every hd in [1, 128] runs at the next of 16, 32, 64,
    128 (``_launch_bwd`` pads to it as the forward pads); outside, it
    raises as the forward does."""
    assert [wk.bwd_head_dim(hd) for hd in (1, 16, 17, 32, 48, 64, 65, 80, 128)] == [
        16, 16, 32, 32, 64, 64, 128, 128, 128]
    for hd in (0, 129):
        with pytest.raises(ValueError, match="head dim"):
            wk.bwd_head_dim(hd)


@pytest.mark.parametrize("hd", [8, 24, 72])
def test_pad_head_dim_keeps_the_backward(hd):
    """K7b's path at a head dim that is no multiple of 16, through the plain
    version: inputs padded as the forward pads them, dy and dS_final with
    zeros, the gradients cropped, equal to the backward at hd itself (1e-5
    of each largest entry); the padded rows and columns of ds0 stay zero."""
    b, l, h = 2, 11, 2
    r, k, v, w, u, s0 = _t(*_inputs(b, l, h, hd, hd, s0_scale=0.5))
    dy, ds = _t(*_cotangents(b, l, h, hd, hd))
    hp = wk.padded_head_dim(hd)
    padded = wk.pad_head_dim(r, k, v, w, u, s0)
    pad_dy = torch.nn.functional.pad(dy, (0, hp - hd))
    pad_ds = torch.nn.functional.pad(ds, (0, hp - hd, 0, hp - hd))
    got = wk.wkv6_bwd_ref(*padded[:5], pad_dy, padded[5], pad_ds)
    want = wk.wkv6_bwd_ref(r, k, v, w, u, dy, s0, ds)
    for name, g, wnt in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        _frac_close(g[..., :hd].numpy(), wnt.numpy(), 1e-5, name)
    _frac_close(got[5][..., :hd, :hd].numpy(), want[5].numpy(), 1e-5, "ds0")
    assert not got[5][..., hd:, :].any() and not got[5][..., :, hd:].any()


@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_fn_gradcheck(with_s0):
    """``torch.autograd.gradcheck`` in float64 through ``Wkv6Fn`` (on the
    CPU: ``wkv6_ref`` forward, ``wkv6_bwd_ref`` backward), y and the final
    state both used."""
    r, k, v, w, u, s0 = (torch.from_numpy(a).double() for a in
                         _inputs(2, 6, 2, 4, 9, s0_scale=0.5))
    args = [t.requires_grad_(True) for t in (r, k, v, w, u, s0)]
    if not with_s0:
        args[5] = None
    assert torch.autograd.gradcheck(wk.Wkv6Fn.apply, tuple(args), eps=1e-6, atol=1e-7)


def test_wkv6_takes_wkv6_fn_under_a_gradient():
    """``wkv6`` goes through ``Wkv6Fn`` where grad is enabled and an input
    requires it (any one of r, k, v, w, u, s0); a state written in place
    takes no gradient; under ``no_grad`` the forward alone runs."""
    r, k, v, w, u, s0 = _t(*_inputs(1, 10, 2, 16, 4, s0_scale=0.5))
    for i in range(6):
        args = [r, k, v, w, u, s0]
        args[i] = args[i].clone().requires_grad_(True)
        y, s = wk.wkv6(*args)
        assert type(y.grad_fn).__name__ == "Wkv6FnBackward"
        (y.sum() + s.sum()).backward()
        assert args[i].grad is not None and args[i].grad.abs().max() > 0
        with torch.no_grad():
            assert wk.wkv6(*args)[0].grad_fn is None
    with pytest.raises(ValueError, match="state_out"):
        wk.wkv6(r, k, v, w, u.clone().requires_grad_(True), s0, state_out=s0.clone())
    with pytest.raises(ValueError, match="dy must be"):
        wk.wkv6_bwd(r, k, v, w, u, r[:, :3])
