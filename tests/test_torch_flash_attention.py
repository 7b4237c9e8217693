"""Flash attention of the PyTorch port against the JAX package's kernels.

On the CPU the port computes its plain twins; the JAX side runs its Pallas
kernels in interpret mode with 64-token blocks (128 for the head-packed
kernel), as tests/test_ops.py does.
Tolerances are the JAX tests' own: forward 2e-5 (fp32) and 3e-2 (bf16);
gradients 3e-5 (fp32) and 6e-2 (bf16), the tolerances
tests/test_ops.py holds the Pallas backward to.

The CUDA kernels themselves are held against these twins on the GPU by
tests/test_torch_cuda.py.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.ops import flash_attention as jax_flash
from autodiffusion_tpu.ops.flash_attention import (_flash_bwd,
                                                  _flash_forward,
                                                  _flash_forward_packed)
from autodiffusion_tpu_torch.models import create_sd_models
from autodiffusion_tpu_torch.ops.flash_attention import (
    LAUNCHES, FlashAttentionFunction, flash_attention,
    flash_attention_reference, flash_bwd_dkv, flash_bwd_dkv_plain,
    flash_bwd_dq, flash_bwd_dq_plain, flash_fwd, flash_fwd_packed,
    flash_fwd_packed_plain, flash_fwd_plain, multihead_attention,
    reset_launch_counts)
from test_torch_package import one_torch_thread  # noqa: F401


def _jax(q, k, v):
    return jax_flash(q, k, v, block_q=64, block_kv=64, interpret=True)


def _inputs(t, s, d, dtype, seed):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(2, 2, n, d).astype(np.float32) for n in (t, s, s, t)]
    if dtype == "bfloat16":
        # round through bf16 once so both sides see identical inputs
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                for a in arrs]
    return arrs


def _to_torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _to_jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


@pytest.mark.parametrize("t,s,d", [(128, 128, 64), (100, 100, 64),
                                   (64, 300, 32)])
def test_twin_forward_matches_pallas_fp32(t, s, d):
    q, k, v, _ = _inputs(t, s, d, "float32", 0)
    want = np.asarray(_jax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype,t,s,tol", [("float32", 100, 100, 3e-5),
                                           ("float32", 64, 300, 3e-5),
                                           ("bfloat16", 128, 128, 6e-2),
                                           ("bfloat16", 100, 70, 6e-2)])
def test_twin_gradients_match_pallas_backward(dtype, t, s, tol):
    q, k, v, g = _inputs(t, s, 64, dtype, 1)
    jq, jk, jv, jg = (_to_jax(a, dtype) for a in (q, k, v, g))
    out_j, vjp = jax.vjp(_jax, jq, jk, jv)
    want = vjp(jg)
    tq, tk, tv = (_to_torch(a, dtype).requires_grad_(True) for a in (q, k, v))
    out_t = flash_attention(tq, tk, tv)
    assert out_t.dtype == getattr(torch, dtype)
    got = torch.autograd.grad(out_t, (tq, tk, tv), _to_torch(g, dtype))
    fwd_tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(out_t.float().detach().numpy(),
                               np.asarray(out_j, np.float32),
                               atol=fwd_tol, rtol=fwd_tol)
    for a, b, name in zip(got, want, "qkv"):
        assert a.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=tol, rtol=tol, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_twins_through_autograd_match_pallas(dtype):
    """FlashAttentionFunction on CPU tensors runs the three kernels' plain
    twins (fwd -> lse, delta, dq, dk/dv): its output, lse and gradients
    match the Pallas forward (lse included) and backward."""
    t, s = 100, 130
    q, k, v, g = _inputs(t, s, 64, dtype, 2)
    jq, jk, jv = (_to_jax(a, dtype) for a in (q, k, v))
    _, lse_j = _flash_forward(jq, jk, jv, 64, 64, True)
    _, vjp = jax.vjp(_jax, jq, jk, jv)
    want = vjp(_to_jax(g, dtype))
    tq, tk, tv = (_to_torch(a, dtype).reshape(4, -1, 64).requires_grad_(True)
                  for a in (q, k, v))
    _, lse = flash_fwd(tq.detach(), tk.detach(), tv.detach())
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :t],
                               atol=2e-5, rtol=2e-5)
    out = FlashAttentionFunction.apply(tq, tk, tv)
    got = torch.autograd.grad(out, (tq, tk, tv),
                              _to_torch(g, dtype).reshape(4, t, 64))
    tol = 3e-5 if dtype == "float32" else 6e-2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32).reshape(a.shape),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,t,s", [
    # the classifier's D = 64 at the CUDA kernel's ring edges: T off the
    # 64-query tile, S off the 128-key block, S under one block, T under
    # one tile
    ("float32", 77, 50), ("float32", 130, 129), ("float32", 100, 300),
    ("float32", 40, 129), ("bfloat16", 130, 129), ("bfloat16", 77, 300)])
def test_dkv_twin_matches_pallas_dkv_kernel(dtype, t, s):
    """flash_bwd_dkv on CPU tensors (the dK/dV kernel's twin) against the
    Pallas dK/dV kernel in interpret mode (``_flash_bwd``), each side fed
    its own forward's lse and o: 3e-5 (fp32), 6e-2 (bf16)."""
    q, k, v, g = _inputs(t, s, 64, dtype, t + s)
    jq, jk, jv, jg = (_to_jax(a, dtype) for a in (q, k, v, g))
    o_j, lse_j = _flash_forward(jq, jk, jv, 64, 64, True)
    _, dk_j, dv_j = _flash_bwd(64, 64, True, False, False,
                               (jq, jk, jv, o_j, lse_j), jg)
    tq, tk, tv, tg = (_to_torch(a, dtype).reshape(4, -1, 64)
                      for a in (q, k, v, g))
    o, lse = flash_fwd(tq, tk, tv)
    delta = (tg.float() * o.float()).sum(-1)
    reset_launch_counts()
    dk, dv = flash_bwd_dkv(tq, tk, tv, tg, lse, delta)
    assert set(LAUNCHES.values()) == {0}
    tol = 3e-5 if dtype == "float32" else 6e-2
    for name, got, want in (("dk", dk, dk_j), ("dv", dv, dv_j)):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32).reshape(4, s, 64),
            atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("dtype,t,s", [
    # the dQ kernel's tile edges: T off the 128-row block and the 64-row
    # warpgroup (77, 130, 200), S off the 64-key tile (50, 129, 300), T
    # under one warpgroup (40), S under one tile with several query blocks
    # (300, 50)
    ("float32", 77, 129), ("float32", 200, 300), ("float32", 40, 50),
    ("float32", 300, 50), ("bfloat16", 130, 129), ("bfloat16", 40, 300),
    ("bfloat16", 300, 50)])
def test_dq_twin_matches_pallas_dq_kernel(dtype, t, s):
    """flash_bwd_dq on CPU tensors (the dQ kernel's twin) against the
    Pallas dQ kernel in interpret mode (``_flash_bwd``), each side fed its
    own forward's lse and o: 3e-5 (fp32), 6e-2 (bf16)."""
    q, k, v, g = _inputs(t, s, 64, dtype, 2 * t + s)
    jq, jk, jv, jg = (_to_jax(a, dtype) for a in (q, k, v, g))
    o_j, lse_j = _flash_forward(jq, jk, jv, 64, 64, True)
    dq_j, _, _ = _flash_bwd(64, 64, True, False, False,
                            (jq, jk, jv, o_j, lse_j), jg)
    tq, tk, tv, tg = (_to_torch(a, dtype).reshape(4, -1, 64)
                      for a in (q, k, v, g))
    o, lse = flash_fwd(tq, tk, tv)
    delta = (tg.float() * o.float()).sum(-1)
    reset_launch_counts()
    dq = flash_bwd_dq(tq, tk, tv, tg, lse, delta)
    assert set(LAUNCHES.values()) == {0}
    assert dq.dtype == getattr(torch, dtype)
    tol = 3e-5 if dtype == "float32" else 6e-2
    np.testing.assert_allclose(
        dq.float().numpy(), np.asarray(dq_j, np.float32).reshape(4, t, 64),
        atol=tol, rtol=tol)


def test_twin_softmax_stability_large_logits():
    q = torch.full((1, 64, 32), 30.0)
    out = flash_attention_reference(q, q.clone(), torch.ones(1, 64, 32))
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-5)


def test_cpu_wrappers_run_twins_without_counting():
    reset_launch_counts()
    rng = np.random.RandomState(3)
    q, k, v, do = (torch.from_numpy(rng.randn(3, 40, 16).astype(np.float32))
                   for _ in range(4))
    o, lse = flash_fwd(q, k, v)
    o2, lse2 = flash_fwd_plain(q, k, v)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    delta = (do * o).sum(-1)
    assert torch.equal(flash_bwd_dq(q, k, v, do, lse, delta),
                       flash_bwd_dq_plain(q, k, v, do, lse, delta))
    assert all(torch.equal(a, b) for a, b in zip(
        flash_bwd_dkv(q, k, v, do, lse, delta),
        flash_bwd_dkv_plain(q, k, v, do, lse, delta)))
    assert set(LAUNCHES.values()) == {0}


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(TypeError):
        flash_fwd(q, q.double(), q)
    with pytest.raises(ValueError):
        flash_fwd(q, torch.zeros(2, 8, 32), torch.zeros(2, 8, 32))
    with pytest.raises(ValueError):
        flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


def _tokens(a):
    """[B, H, L, D] -> token-major [B, L, H * D]."""
    b, h, n, d = a.shape
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 2, 1, 3).reshape(b, n, h * d)))


@pytest.mark.parametrize("t,s", [(128, 128), (128, 77), (200, 200),
                                 (200, 77)])
def test_packed_twin_matches_pallas_packed_kernel(t, s):
    """flash_fwd_packed's twin (token-major [B, T, H * D], D = 40, 8
    heads) against the JAX head-packed kernel with G = 3 heads a step
    (8 heads: 3 groups, the last one padded), o and lse, float32: 2e-5."""
    _check_packed_twin(2, 8, 40, t, s, np.random.RandomState(5))


def _check_packed_twin(b, heads, d, t, s, rng):
    """The packed twin against the JAX head-packed kernel (G = 128 // D
    heads a step), o and lse, float32: 2e-5."""
    q = rng.randn(b, heads, t, d).astype(np.float32)
    k, v = (rng.randn(b, heads, s, d).astype(np.float32) for _ in range(2))
    o_j, lse_j = _flash_forward_packed(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), 128, 128, True,
                                       False, 128 // d)
    o, lse = flash_fwd_packed(_tokens(q), _tokens(k), _tokens(v), heads)
    np.testing.assert_allclose(
        o.numpy(), np.asarray(o_j).transpose(0, 2, 1, 3).reshape(b, t, -1),
        atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("b,heads,d,t,s", [
    # the shapes at the edges of the bf16 kernel's key ring that
    # tests/test_torch_cuda.py runs on the card: every packed head dim, S
    # under one 128-key tile (77), S past all the stages (1000), ragged T
    (2, 8, 16, 1000, 1000), (2, 3, 16, 257, 77), (2, 4, 32, 1000, 77),
    (2, 4, 32, 333, 1000), (2, 8, 40, 1000, 1000), (2, 8, 40, 1000, 77),
    (3, 5, 64, 333, 1000), (2, 5, 64, 1000, 77)])
def test_packed_twin_matches_pallas_at_ring_edges(b, heads, d, t, s):
    _check_packed_twin(b, heads, d, t, s, np.random.RandomState(d + t + s))


def test_sd_sites_are_the_known_ones(monkeypatch):
    """multihead_attention at full width (meta device, batch 1): the SD
    UNet's packed calls are the 64x64 level's self- and cross-attention
    (D = 40, 8 heads), and the decoder's one D = 512 call is the
    mid-block over 4096 tokens; nothing else reaches either kernel."""
    fa = sys.modules["autodiffusion_tpu_torch.ops.flash_attention"]

    def sites(part):
        packed, wide = set(), set()

        def rec_packed(q, k, v, heads, **kw):
            packed.add((q.shape[1], k.shape[1], heads, q.shape[2] // heads))
            return torch.empty_like(q), None

        def rec_fwd(q, k, v, heads=1):
            if q.shape[-1] == 512:
                wide.add((q.shape[0], q.shape[1], k.shape[1]))
            return torch.empty_like(q), None

        monkeypatch.setattr(fa, "flash_fwd_packed", rec_packed)
        monkeypatch.setattr(fa, "flash_fwd", rec_fwd)
        with torch.device("meta"):
            unet, vae, _ = create_sd_models(device="meta")
            if part == "unet":
                unet(torch.empty(1, 4, 64, 64), torch.zeros(1),
                     torch.empty(1, 77, 768))
            else:
                vae.decode(torch.empty(1, 4, 64, 64))
        return packed, wide

    assert sites("unet") == ({(4096, 4096, 8, 40), (4096, 77, 8, 40)}, set())
    assert sites("decode") == (set(), {(1, 4096, 4096)})


@pytest.mark.parametrize("d,t,s", [
    (80, 100, 100), (80, 128, 77), (512, 128, 128), (512, 70, 90),
    # where the CUDA kernel changes its blocking: T = S = 64 (one 64-row
    # block, one key tile), ragged T and S (130 / 129, 77 keys)
    (64, 64, 64), (80, 64, 64), (80, 130, 129), (80, 200, 77),
    (128, 64, 64), (128, 130, 77)])
def test_forward_twin_matches_pallas_at_sd_head_dims(d, t, s):
    """flash_fwd's twin at D = 80 (SD 32x32) and D = 512 (the VAE
    mid-block), and at the CUDA kernel's block edges at D = 64, 80 and
    128, against the JAX kernel, o and lse, float32: 2e-5."""
    q, k, v, _ = _inputs(t, s, d, "float32", 6)
    want = np.asarray(_jax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    _, lse_j = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              64, 64, True)
    o, lse = flash_fwd(*(torch.from_numpy(a).reshape(4, -1, d)
                         for a in (q, k, v)))
    np.testing.assert_allclose(o.numpy().reshape(want.shape), want,
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :t],
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("t,s", [(64, 64), (100, 77), (130, 129)])
def test_multihead_attention_d80_takes_the_token_major_route(monkeypatch, t,
                                                             s):
    """At D = 80 multihead_attention hands flash_fwd the token-major
    projections as they are ([B, T, H * D], heads = H: no head
    transposes), and on the CPU its result is the heads-first twin's."""
    fa = sys.modules["autodiffusion_tpu_torch.ops.flash_attention"]
    heads, d = 8, 80
    rng = np.random.RandomState(t + s)
    q = torch.from_numpy(rng.randn(2, t, heads * d).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(2, s, heads * d).astype(np.float32))
            for _ in range(2))
    seen = []
    real = fa.flash_fwd

    def record(q_, k_, v_, heads=1):
        seen.append((tuple(q_.shape), tuple(k_.shape), heads,
                     q_.data_ptr() == q.data_ptr()))
        return real(q_, k_, v_, heads=heads)

    monkeypatch.setattr(fa, "flash_fwd", record)
    got = multihead_attention(q, k, v, heads)
    assert seen == [((2, t, heads * d), (2, s, heads * d), heads, True)]
    heads_first = [z.reshape(2, -1, heads, d).transpose(1, 2)
                   .reshape(2 * heads, -1, d) for z in (q, k, v)]
    o, _ = flash_fwd_plain(*heads_first)
    want = o.reshape(2, heads, t, d).transpose(1, 2).reshape(2, t, -1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6,
                               rtol=2e-6)
    o2, lse2 = real(q, k, v, heads=heads)
    assert torch.equal(o2, got) and lse2.shape == (2 * heads, t)


@pytest.mark.parametrize("heads,d,want", [
    (8, 40, ("flash_fwd_packed", 2, 8)), (8, 80, ("flash_fwd", 2, 8)),
    (4, 64, ("flash_fwd", 2, 4)), (2, 32, ("flash_fwd", 2, 2)),
    (3, 16, ("flash_fwd", 2, 3)), (1, 512, ("flash_fwd", 2, 1)),
    (2, 512, ("flash_fwd", 4, 1)), (2, 160, None)])
def test_multihead_attention_picks_the_wrapper_by_head_dim(monkeypatch, heads,
                                                           d, want):
    """Which wrapper multihead_attention hands each head dim, and in which
    layout ((wrapper, leading dim, heads)): D = 40 the packed kernel and
    D in FWD_HEAD_DIMS flash_fwd, both on the token-major [B, T, H * D]
    projections; D = 512 flash_fwd (its wide kernel) on [B * H, T, 512],
    with one head or several; D = 160 neither. The result is the
    reference math's."""
    fa = sys.modules["autodiffusion_tpu_torch.ops.flash_attention"]
    seen = []
    real = {n: getattr(fa, n) for n in ("flash_fwd", "flash_fwd_packed")}

    def recorder(name):
        def call(q_, k_, v_, heads=1):
            seen.append((name, q_.shape[0], heads))
            return real[name](q_, k_, v_, heads=heads)
        return call

    for name in real:
        monkeypatch.setattr(fa, name, recorder(name))
    rng = np.random.RandomState(d + heads)
    q = torch.from_numpy(rng.randn(2, 20, heads * d).astype(np.float32))
    c = torch.from_numpy(rng.randn(2, 9, heads * d).astype(np.float32))
    got = multihead_attention(q, c, c, heads)
    assert seen == ([want] if want else [])
    ref = flash_attention_reference(
        *(z.reshape(2, -1, heads, d).transpose(1, 2) for z in (q, c, c)))
    np.testing.assert_allclose(
        got.numpy(), ref.transpose(1, 2).reshape(2, 20, -1).numpy(),
        atol=2e-6, rtol=2e-6)


def test_multihead_attention_twins_agree_across_routes():
    """On the CPU every route (packed D = 40, flash_fwd D = 80 and 512,
    plain D = 160) is the same function: each against the reference
    math."""
    rng = np.random.RandomState(7)
    reset_launch_counts()
    for heads, d in ((8, 40), (2, 80), (2, 160), (1, 512), (3, 12)):
        q = torch.from_numpy(rng.randn(2, 30, heads * d).astype(np.float32))
        c = torch.from_numpy(rng.randn(2, 9, heads * d).astype(np.float32))
        got = multihead_attention(q, c, c, heads)
        want = flash_attention_reference(
            *(z.reshape(2, -1, heads, d).transpose(1, 2) for z in (q, c, c)))
        np.testing.assert_allclose(
            got.numpy(), want.transpose(1, 2).reshape(2, 30, -1).numpy(),
            atol=2e-6, rtol=2e-6)
    assert set(LAUNCHES.values()) == {0}


def test_packed_and_wide_wrappers_reject_bad_inputs():
    q = torch.zeros(2, 8, 80)
    with pytest.raises(ValueError, match="heads"):
        flash_fwd_packed(q, q, q, 3)
    with pytest.raises(ValueError):
        flash_fwd_packed(q, torch.zeros(3, 8, 80), torch.zeros(3, 8, 80), 2)
    with pytest.raises(ValueError):
        flash_fwd_packed(q[0], q[0], q[0], 2)
    with pytest.raises(TypeError):
        flash_fwd_packed(q, q.half(), q, 2)
    with pytest.raises(TypeError):
        flash_fwd(torch.zeros(1, 4, 512), torch.zeros(1, 4, 512).double(),
                  torch.zeros(1, 4, 512))
    with pytest.raises(ValueError):
        multihead_attention(q.to("meta"), q.to("meta"), q.to("meta"), 2)
