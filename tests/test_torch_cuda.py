"""The port's CUDA kernels on the GPU, held against their plain twins:
flash attention (forward at D <= 128 and D = 512, the packed small-head-dim
forward, dQ, dK/dV), the fused GroupNorm (forward, backward) and the 3x3
convolutions (im2col, fused norm-act-conv); and the paths that run them
end to end at a tiny size, GPU against CPU: guided ancestral sampling,
DPM-Solver through an SD UNet, and the FID evaluator.

Every test here needs an NVIDIA GPU and nvcc, is marked ``cuda``, and
skips where ``torch.cuda.is_available()`` is false. The file imports no
JAX, so that it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Limits on |kernel - twin|, elementwise, as chip_smoke.py holds them:
float32 2e-5 (1 + |twin|), the JAX tests' own tolerance for the TPU kernels
(tests/test_ops.py); bfloat16 2^-6 |twin| + 2^-8 max|twin|, a few bf16
units in the last place, since the sums run in other orders than the
twins' and the rounding of o, p and dS to bf16 can land one unit apart.
The lse is float32 in both dtypes and takes the float32 limit. Gradients
through autograd of the plain twin (which rounds dP to bf16 where the
kernels do not) are held to 3e-5 (fp32) and 6e-2 (bf16) (1 + |twin|).
The GroupNorm backward's per-channel sums (dscale, dshift, dgamma, dbeta:
float32 sums over up to B x HW terms, in another order than the twin's)
take 2e-4 (1 + |twin|), the JAX package's own gradient tolerance for the
TPU kernels (tests/test_fused_norm.py). The conv twins run their float32
convolutions with TF32 off. The end-to-end paths run float32 with TF32
off and hold the GPU's output to 1e-3 of its scale, as chip_smoke.py's
parity phases do at full width, the evaluator's FID to 1e-3 relative.
"""

import pytest
import torch

from autodiffusion_tpu_torch.ops.conv_im2col import (
    conv3x3, conv3x3_fused, conv3x3_fused_kernel, conv3x3_im2col,
    conv3x3_reference, conv_plan, fused_conv_reference)
from autodiffusion_tpu_torch.ops.flash_attention import (
    FWD_HEAD_DIMS, LAUNCHES, SUPPORTED_HEAD_DIMS, flash_attention, flash_attention_reference,
    flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain,
    flash_fwd, flash_fwd_packed, flash_fwd_packed_plain, flash_fwd_plain,
    multihead_attention, reset_launch_counts)
from autodiffusion_tpu_torch.ops.fused_norm import (
    FusedGroupNormFunction, group_norm_bwd,
    group_norm_bwd_plain, group_norm_fwd, group_norm_fwd_plain,
    group_norm_reference)

GRAD_TOL = {torch.float32: 3e-5, torch.bfloat16: 6e-2}
SUM_TOL = 2e-4


def _launched(**want):
    """LAUNCHES with every kernel not named at 0."""
    return {k: want.get(k, 0) for k in LAUNCHES}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(gen, dev, dtype, *shape):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


def _assert_within_limit(got, want, dtype, name, f32_tol=2e-5):
    assert got.dtype == want.dtype, name
    diff = (got.float() - want.float()).abs()
    a = want.float().abs()
    if dtype == torch.float32:
        lim = f32_tol * (1 + a)
    else:
        lim = 2 ** -6 * a + 2 ** -8 * a.max()
    worst = float((diff / lim.clamp_min(1e-30)).max())
    assert worst <= 1, f"{name}: max |d| / limit = {worst:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,s,d", [(256, 256, 64), (100, 300, 64),
                                   (77, 50, 32), (130, 129, 128),
                                   (64, 64, 16), (1000, 1000, 64)])
def test_kernels_match_twins(cuda_device, dtype, t, s, d):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, do = (_randn(gen, cuda_device, dtype, 6, t, d) for _ in range(2))
    k, v = (_randn(gen, cuda_device, dtype, 6, s, d) for _ in range(2))
    reset_launch_counts()
    o, lse = flash_fwd(q, k, v)
    o_ref, lse_ref = flash_fwd_plain(q, k, v)
    delta = (do.float() * o_ref.float()).sum(-1)
    pairs = {"o": (o, o_ref), "lse": (lse, lse_ref),
             "dq": (flash_bwd_dq(q, k, v, do, lse_ref, delta),
                    flash_bwd_dq_plain(q, k, v, do, lse_ref, delta))}
    dk, dv = flash_bwd_dkv(q, k, v, do, lse_ref, delta)
    dk_ref, dv_ref = flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta)
    pairs.update(dk=(dk, dk_ref), dv=(dv, dv_ref))
    torch.cuda.synchronize()
    for name, (got, want) in pairs.items():
        _assert_within_limit(got, want,
                             torch.float32 if name == "lse" else dtype, name)
    assert LAUNCHES == _launched(flash_fwd=1, flash_bwd_dq=1,
                                 flash_bwd_dkv=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_kernels_matches_twin(cuda_device, dtype):
    """flash_attention on CUDA tensors ([B, H, T, D], as AttentionBlock
    calls it): its output and gradients against the chain of the kernels'
    plain twins (the forward's lse and o feeding the backward) within the
    kernel limits, and against autograd of the plain twin."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v, g = (_randn(gen, cuda_device, dtype, 2, 3, 200, 64)
                  for _ in range(4))
    leaves = [z.clone().requires_grad_(True) for z in (q, k, v)]
    twins = [z.clone().requires_grad_(True) for z in (q, k, v)]
    reset_launch_counts()
    out = flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, g)
    assert LAUNCHES == _launched(flash_fwd=1, flash_bwd_dq=1,
                                 flash_bwd_dkv=1)
    flat = [z.reshape(6, 200, 64) for z in (q, k, v, g)]
    o_ref, lse_ref = flash_fwd_plain(*flat[:3])
    delta = (flat[3].float() * o_ref.float()).sum(-1)
    chain = [o_ref, flash_bwd_dq_plain(*flat, lse_ref, delta),
             *flash_bwd_dkv_plain(*flat, lse_ref, delta)]
    for name, a, b in zip(("o", "dq", "dk", "dv"), [out, *got], chain):
        _assert_within_limit(a.detach().reshape(b.shape), b, dtype, name)
    ref = flash_attention_reference(*twins)
    want = torch.autograd.grad(ref, twins, g)
    _assert_within_limit(out.detach(), ref.detach(), dtype, "o")
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), atol=GRAD_TOL[dtype],
                                   rtol=GRAD_TOL[dtype],
                                   msg=lambda m: f"d{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("t,s", [
    # the dK/dV kernel's ring and blocks: T off the query tile (77, 130,
    # 1000), S off the 128-key block (50, 129, 300), T under one tile
    # (20), S under one block with many tiles through the ring (1000, 64)
    (77, 50), (130, 129), (1000, 300), (20, 129), (1000, 64)])
def test_dkv_ring_edges_match_twin(cuda_device, dtype, d, t, s):
    gen = torch.Generator(device=cuda_device).manual_seed(d + t + s)
    q, do = (_randn(gen, cuda_device, dtype, 5, t, d) for _ in range(2))
    k, v = (_randn(gen, cuda_device, dtype, 5, s, d) for _ in range(2))
    o_ref, lse_ref = flash_fwd_plain(q, k, v)
    delta = (do.float() * o_ref.float()).sum(-1)
    reset_launch_counts()
    dk, dv = flash_bwd_dkv(q, k, v, do, lse_ref, delta)
    dk_ref, dv_ref = flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta)
    torch.cuda.synchronize()
    assert LAUNCHES == _launched(flash_bwd_dkv=1)
    _assert_within_limit(dk, dk_ref, dtype, "dk")
    _assert_within_limit(dv, dv_ref, dtype, "dv")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("t,s", [
    # the dQ kernel's tiles: T off the 128-row block and the 64-row
    # warpgroup (77, 130, 200), S off the 64-key tile (50, 129, 300), T
    # under one warpgroup (40), S under one tile with several query blocks
    # (300, 50)
    (77, 129), (130, 50), (200, 300), (40, 129), (300, 50)])
def test_dq_tile_edges_match_twin(cuda_device, dtype, d, t, s):
    gen = torch.Generator(device=cuda_device).manual_seed(d + 2 * t + s)
    q, do = (_randn(gen, cuda_device, dtype, 5, t, d) for _ in range(2))
    k, v = (_randn(gen, cuda_device, dtype, 5, s, d) for _ in range(2))
    o_ref, lse_ref = flash_fwd_plain(q, k, v)
    delta = (do.float() * o_ref.float()).sum(-1)
    reset_launch_counts()
    dq = flash_bwd_dq(q, k, v, do, lse_ref, delta)
    dq_ref = flash_bwd_dq_plain(q, k, v, do, lse_ref, delta)
    torch.cuda.synchronize()
    assert LAUNCHES == _launched(flash_bwd_dq=1)
    _assert_within_limit(dq, dq_ref, dtype, "dq")


@pytest.mark.cuda
def test_unsupported_head_dim_raises(cuda_device):
    q = torch.zeros(1, 8, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_fwd(q, q, q)


def _limit_ratio(got, want, dtype):
    """max |got - want| / limit (the limits of _assert_within_limit)."""
    diff = (got.float() - want.float()).abs()
    a = want.float().abs()
    lim = 2e-5 * (1 + a) if dtype == torch.float32 else \
        2 ** -6 * a + 2 ** -8 * a.max()
    return float((diff / lim.clamp_min(1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,s,d", [
    (1024, 1024, 80), (1024, 77, 80), (300, 200, 80), (700, 650, 512),
    (64, 130, 512)] + [
    # every head dim of flash_fwd: the one-warpgroup block (T <= 64),
    # ragged T and S, S under one key tile (77)
    (t, s, d) for d in FWD_HEAD_DIMS
    for t, s in ((64, 64), (64, 77), (1000, 1000), (1000, 77), (130, 129))])
def test_forward_new_head_dims_match_twin(cuda_device, dtype, t, s, d):
    """flash_fwd at every head dim of its kernel, D = 80 (the SD 32x32
    level) among them, and D = 512 (the VAE mid-block, the flash_fwd_wide
    kernel); a run with one 64-key tile left out breaks the limit."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q = _randn(gen, cuda_device, dtype, 2, t, d)
    k, v = (_randn(gen, cuda_device, dtype, 2, s, d) for _ in range(2))
    reset_launch_counts()
    o, lse = flash_fwd(q, k, v)
    o_ref, lse_ref = flash_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    stem = "flash_fwd_wide" if d == 512 else "flash_fwd"
    assert LAUNCHES == _launched(**{stem: 1})
    _assert_within_limit(o, o_ref, dtype, "o")
    _assert_within_limit(lse, lse_ref, torch.float32, "lse")
    if s > 64:
        dropped = flash_fwd(q, k[:, 64:], v[:, 64:])[0]
        assert _limit_ratio(dropped, o_ref, dtype) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,t", [(56, 1024), (84, 256), (112, 64),
                                 (16, 4096), (24, 1024), (32, 256)])
def test_ldm_adm_layout_sites_match_twin(cuda_device, dtype, n, t):
    """flash_fwd on the ADM blocks' [B H, T, D] layout at the LDM UNets'
    D = 32 sites: ldm-sample's 4 samples at T 1024 / 256 / 64 with 14 /
    21 / 28 heads, inpaint's one at T 4096 / 1024 / 256 with 16 / 24 / 32;
    a run with one 64-key tile left out breaks the limit."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    q, k, v = (_randn(gen, cuda_device, dtype, n, t, 32) for _ in range(3))
    reset_launch_counts()
    o, lse = flash_fwd(q, k, v)
    o_ref, lse_ref = flash_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES == _launched(flash_fwd=1)
    _assert_within_limit(o, o_ref, dtype, "o")
    _assert_within_limit(lse, lse_ref, torch.float32, "lse")
    if t > 64:
        dropped = flash_fwd(q, k[:, 64:], v[:, 64:])[0]
        assert _limit_ratio(dropped, o_ref, dtype) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,hw", [(512, 32), (1024, 16), (1024, 8)])
def test_lsun_legacy_order_attention_sites_match_cpu(cuda_device, no_tf32,
                                                     monkeypatch, dtype,
                                                     channels, hw):
    """The LSUN-256 UNet's attention sites: an AttentionBlock in
    guided-diffusion's legacy QKV order (use_new_attention_order False)
    with head width 64, 512 channels at 32 x 32 (8 heads, T 1024) and
    1024 at 16 x 16 and 8 x 8 (16 heads, T 256 and 64), forward only as
    sampling runs it, with the flash gate off (ADT_FLASH_GATE=0) so that
    the site is on its kernel whatever the gate routes: one flash_fwd
    launch (and the fused GroupNorm's forward for the block's norm), the
    output against the same block on the CPU (the twin), float32 within
    1e-3 of the scale, bf16 within 2e-2."""
    from autodiffusion_tpu_torch.models.unet import AttentionBlock

    monkeypatch.setenv("ADT_FLASH_GATE", "0")
    torch.manual_seed(channels + hw)
    blk = AttentionBlock(channels, num_head_channels=64,
                         use_new_attention_order=False)
    with torch.no_grad():
        blk.proj_out.weight.normal_(0, 0.05)
    x = torch.randn(2, channels, hw, hw)
    with torch.no_grad():
        want = blk(x)
        gpu = blk.to(cuda_device)
        reset_launch_counts()
        out = gpu(x.to(cuda_device, dtype))
    torch.cuda.synchronize()
    assert LAUNCHES == _launched(flash_fwd=1, group_norm_fwd=1)
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    scale = float(want.abs().max())
    assert float((out.float().cpu() - want).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_forward_at_the_vae_site(cuda_device, dtype):
    """flash_fwd_wide at the VAE mid-block's T = S = 4096 (batch 1): every
    key tile and both consumers' halves of the contraction; a run with one
    64-key tile left out breaks the limit."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v = (_randn(gen, cuda_device, dtype, 1, 4096, 512) for _ in range(3))
    reset_launch_counts()
    o, lse = flash_fwd(q, k, v)
    o_ref, lse_ref = flash_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES == _launched(flash_fwd_wide=1)
    _assert_within_limit(o, o_ref, dtype, "o")
    _assert_within_limit(lse, lse_ref, torch.float32, "lse")
    dropped = flash_fwd(q, k[:, 64:], v[:, 64:])[0]
    assert _limit_ratio(dropped, o_ref, dtype) > 1


def _packed_inputs(gen, dev, dtype, b, heads, d, t, s):
    """Token-major q, k, v, the values of every other head eight times
    larger, so that a kernel reading a neighbouring head's features breaks
    the limit."""
    scale = torch.tensor([1.0 if h % 2 == 0 else 8.0 for h in range(heads)],
                         device=dev).repeat_interleave(d)
    q = torch.randn(b, t, heads * d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, s, heads * d, generator=gen, device=dev).to(dtype)
    v = (torch.randn(b, s, heads * d, generator=gen, device=dev)
         * scale).to(dtype)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,d,t,s", [
    (2, 8, 40, 300, 300), (2, 8, 40, 256, 77), (3, 8, 40, 130, 129),
    (2, 5, 40, 100, 70), (1, 4, 40, 64, 64), (2, 2, 40, 50, 40),
    # the edges of the bf16 kernel's ring (keys in tiles of 128, at most
    # 4 stages): S under one tile (77), S not a multiple of the tile and
    # longer than all the stages together (1000), ragged T, batch > 1
    (2, 8, 40, 1000, 1000), (2, 3, 40, 257, 77), (2, 4, 40, 1000, 77),
    (2, 4, 40, 333, 1000), (3, 5, 40, 333, 1000), (2, 5, 40, 1000, 77)])
def test_packed_forward_matches_twin(cuda_device, dtype, b, heads, d, t, s):
    """flash_fwd_packed on the token-major layout against its twin; runs
    with the heads shifted by one (a wrong head offset), with one 64-key
    tile left out, and (D = 40 in bf16) with the padding chunk read from
    memory (the next head's features) instead of zeroed all break the
    limit."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v = _packed_inputs(gen, cuda_device, dtype, b, heads, d, t, s)
    reset_launch_counts()
    o, lse = flash_fwd_packed(q, k, v, heads)
    o_ref, lse_ref = flash_fwd_packed_plain(q, k, v, heads)
    torch.cuda.synchronize()
    assert LAUNCHES == _launched(flash_fwd_packed=1)
    assert o.shape == q.shape and lse.shape == (b * heads, t)
    _assert_within_limit(o, o_ref, dtype, "o")
    _assert_within_limit(lse, lse_ref, torch.float32, "lse")
    shifted = [z.roll(d, dims=2) for z in (k, v)]
    faults = [flash_fwd_packed(q, *shifted, heads)[0]]
    if s > 64:
        faults.append(flash_fwd_packed(q, k[:, 64:], v[:, 64:], heads)[0])
    if dtype == torch.bfloat16:
        # (the float32 kernel runs on the CUDA cores and pads nothing)
        faults.append(flash_fwd_packed(q, k, v, heads, _raw_pad=True)[0])
    for bad in faults:
        assert _limit_ratio(bad, o_ref, dtype) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,d,t,s", [
    (2, 8, 80, 1024, 1024), (2, 8, 80, 1024, 77), (3, 8, 80, 100, 77),
    (2, 3, 64, 64, 200), (2, 5, 32, 257, 130), (2, 2, 128, 300, 77),
    # D = 16, 32, 64 (which multihead_attention hands flash_fwd on this
    # layout) at the ring's edges: one key tile, S = 1000, ragged T
    (2, 5, 64, 100, 70), (1, 4, 32, 64, 64), (2, 2, 16, 50, 40),
    (2, 8, 16, 1000, 1000), (2, 3, 16, 257, 77), (2, 4, 32, 1000, 77),
    (2, 4, 32, 333, 1000), (3, 5, 64, 333, 1000), (2, 5, 64, 1000, 77),
    # the class-conditional LDM's D = 32 sites: cross-attention over one
    # class token (S = 1) and over 77, and its self-attention
    (4, 6, 32, 1024, 1), (4, 18, 32, 256, 1), (4, 30, 32, 64, 1),
    (4, 12, 32, 1024, 77), (4, 6, 32, 1024, 1024)])
def test_forward_token_major_matches_twin(cuda_device, dtype, b, heads, d, t,
                                          s):
    """flash_fwd on the token-major [B, T, H * D] layout (the SD D = 80
    sites, as multihead_attention hands it the projections) against the
    heads-first twin; runs with the heads shifted by one and (S > 64) with
    one 64-key tile left out break the limit."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v = _packed_inputs(gen, cuda_device, dtype, b, heads, d, t, s)
    reset_launch_counts()
    o, lse = flash_fwd(q, k, v, heads=heads)
    o_ref, lse_ref = flash_fwd_packed_plain(q, k, v, heads)
    torch.cuda.synchronize()
    assert LAUNCHES == _launched(flash_fwd=1)
    assert o.shape == q.shape and lse.shape == (b * heads, t)
    _assert_within_limit(o, o_ref, dtype, "o")
    _assert_within_limit(lse, lse_ref, torch.float32, "lse")
    shifted = [z.roll(d, dims=2) for z in (k, v)]
    faults = [flash_fwd(q, *shifted, heads=heads)[0]]
    if s > 64:
        faults.append(flash_fwd(q, k[:, 64:], v[:, 64:], heads=heads)[0])
    for bad in faults:
        assert _limit_ratio(bad, o_ref, dtype) > 1


@pytest.mark.cuda
def test_multihead_attention_routes_each_head_dim(cuda_device):
    """D = 40 to the packed kernel, D = 64 and 80 to flash_fwd, D = 512
    (one head or several) to flash_fwd_wide, D = 160 to plain PyTorch;
    each against the plain twin."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for heads, d, stem in ((8, 40, "flash_fwd_packed"), (8, 80, "flash_fwd"),
                           (4, 64, "flash_fwd"), (1, 512, "flash_fwd_wide"),
                           (2, 512, "flash_fwd_wide"), (8, 160, None)):
        q = _randn(gen, cuda_device, torch.bfloat16, 2, 100, heads * d)
        ctx = _randn(gen, cuda_device, torch.bfloat16, 2, 77, heads * d)
        reset_launch_counts()
        with torch.no_grad():
            out = multihead_attention(q, ctx, ctx, heads)
        want = flash_fwd_packed_plain(q, ctx, ctx, heads)[0]
        torch.cuda.synchronize()
        assert LAUNCHES == _launched(**({stem: 1} if stem else {}))
        _assert_within_limit(out, want, torch.bfloat16, f"D={d}")


@pytest.mark.cuda
def test_forward_only_kernels_refuse_gradients(cuda_device):
    q = torch.zeros(1, 64, 80, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        flash_fwd(q, q, q)
    qp = torch.zeros(1, 64, 80, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        flash_fwd_packed(qp, qp, qp, 2)


@pytest.fixture
def no_tf32():
    """The conv twins' float32 convolutions in full float32."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = old


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,film,silu", [
    ((4, 192, 32, 32), 32, False, True), ((3, 40, 5, 7), 8, True, True),
    ((2, 768, 8, 8), 32, True, False), ((2, 384, 256), 32, False, False)])
def test_group_norm_kernels_match_twins(cuda_device, dtype, shape, groups,
                                        film, silu):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    b, c = shape[:2]
    x = (1.5 * _randn(gen, cuda_device, torch.float32, *shape) + 0.3).to(dtype)
    dy = _randn(gen, cuda_device, dtype, *shape)
    gamma = 1 + 0.2 * _randn(gen, cuda_device, torch.float32, c)
    beta = 0.1 * _randn(gen, cuda_device, torch.float32, c)
    scale = shift = None
    if film:
        scale, shift = (0.3 * _randn(gen, cuda_device, torch.float32, b, c)
                        for _ in range(2))
    reset_launch_counts()
    y, mu, rstd = group_norm_fwd(x, gamma, beta, scale, shift, groups, 1e-5,
                                 silu)
    y_ref, mu_ref, rstd_ref = group_norm_fwd_plain(x, gamma, beta, scale,
                                                   shift, groups, 1e-5, silu)
    got = group_norm_bwd(x, dy, gamma, beta, scale, shift, mu_ref, rstd_ref,
                         groups, silu)
    want = group_norm_bwd_plain(x, dy, gamma, beta, scale, shift, mu_ref,
                                rstd_ref, groups, silu)
    torch.cuda.synchronize()
    assert LAUNCHES == _launched(group_norm_fwd=1, group_norm_bwd=1)
    _assert_within_limit(y, y_ref, dtype, "y")
    _assert_within_limit(mu, mu_ref, torch.float32, "mu")
    _assert_within_limit(rstd, rstd_ref, torch.float32, "rstd")
    _assert_within_limit(got[0], want[0], dtype, "dx")
    for name, a, b_ in zip(("dscale", "dshift", "dgamma", "dbeta"), got[1:],
                           want[1:]):
        _assert_within_limit(a, b_, torch.float32, name, SUM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,film,silu", [
    ((2, 128, 512, 512), 32, False, True), ((1, 320, 64, 64), 32, True, False),
    ((2, 64, 33, 31), 32, True, True), ((3, 40, 5, 7), 8, False, True),
    ((2, 96, 7), 32, True, False), ((2, 64, 129, 255), 16, False, True),
    # the VQ-f4 decoder's top level: C 128 at 256 x 256 (ldm-sample)
    ((4, 128, 256, 256), 32, False, True),
    # the LSUN-256 UNet's top level: C 256 at 256 x 256, the in-norm and
    # the FiLM out-norm of a ResBlock (1 MB a run in bf16)
    ((2, 256, 256, 256), 32, False, True),
    ((2, 256, 256, 256), 32, True, True)])
def test_group_norm_forward_long_and_odd_runs(cuda_device, dtype, shape,
                                              groups, film, silu):
    """The GroupNorm forward where runs are too long for shared memory and
    split across blocks (the VAE's 512 x 512 slab: 2 MB a run in bf16; a
    129 x 255 slab of 4 channels a group: 263 KB), held in 160 KB of
    shared memory (SD's C 320 at 64 x 64 in float32), and where odd HW
    starts runs off a 16-byte boundary, resident or split; a run with one
    group normalised by another group's statistics breaks the limit."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    b, c = shape[:2]
    x = (_randn(gen, cuda_device, torch.float32, *shape)
         * torch.exp(0.5 * _randn(gen, cuda_device, torch.float32, c,
                                  *([1] * (len(shape) - 2))))
         + 0.3).to(dtype)
    gamma = 1 + 0.2 * _randn(gen, cuda_device, torch.float32, c)
    beta = 0.1 * _randn(gen, cuda_device, torch.float32, c)
    scale = shift = None
    if film:
        scale, shift = (0.3 * _randn(gen, cuda_device, torch.float32, b, c)
                        for _ in range(2))
    reset_launch_counts()
    args = (x, gamma, beta, scale, shift, groups, 1e-6, silu)
    y, mu, rstd = group_norm_fwd(*args)
    y_ref, mu_ref, rstd_ref = group_norm_fwd_plain(*args)
    torch.cuda.synchronize()
    assert LAUNCHES == _launched(group_norm_fwd=1)
    _assert_within_limit(y, y_ref, dtype, "y")
    _assert_within_limit(mu, mu_ref, torch.float32, "mu")
    _assert_within_limit(rstd, rstd_ref, torch.float32, "rstd")
    # group 0 of every sample with group 1's statistics, through the FiLM
    # terms (chip_smoke.py's sabotaged run)
    per = c // groups
    kk = (rstd[:, 1] / rstd[:, 0])[:, None]
    sc = torch.zeros(b, c, device=cuda_device)
    sh = torch.zeros(b, c, device=cuda_device)
    sc[:, :per] = kk - 1
    sh[:, :per] = beta[None, :per] * (1 - kk) + (
        (mu[:, 0] - mu[:, 1]) * rstd[:, 1])[:, None] * gamma[None, :per]
    if film:
        sc, sh = sc + scale, sh + shift
        sc[:, :per] = (1 + scale[:, :per]) * kk - 1
        sh[:, :per] = (1 + scale[:, :per]) * (
            beta[None, :per] * (1 - kk) + ((mu[:, 0] - mu[:, 1])
                                           * rstd[:, 1])[:, None]
            * gamma[None, :per]) + shift[:, :per]
    bad = group_norm_fwd(x, gamma, beta, sc, sh, groups, 1e-6, silu)[0]
    assert _limit_ratio(bad, y_ref, dtype) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_autograd_matches_twin(cuda_device, dtype):
    """FusedGroupNormFunction on CUDA tensors (forward kernel, then the
    backward kernel on its saved mu, rstd) against autograd of the plain
    twin."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = _randn(gen, cuda_device, dtype, 4, 256, 16, 16)
    dy = _randn(gen, cuda_device, dtype, 4, 256, 16, 16)
    gamma = 1 + 0.2 * _randn(gen, cuda_device, torch.float32, 256)
    beta = 0.1 * _randn(gen, cuda_device, torch.float32, 256)
    scale, shift = (0.3 * _randn(gen, cuda_device, dtype, 4, 256)
                    for _ in range(2))
    leaves = [t.clone().requires_grad_(True)
              for t in (x, gamma, beta, scale, shift)]
    twins = [t.clone().requires_grad_(True)
             for t in (x, gamma, beta, scale, shift)]
    reset_launch_counts()
    out = FusedGroupNormFunction.apply(*leaves, 32, 1e-5, True)
    got = torch.autograd.grad(out, leaves, dy)
    assert LAUNCHES == _launched(group_norm_fwd=1, group_norm_bwd=1)
    ref = group_norm_reference(twins[0], twins[1], twins[2], scale=twins[3],
                               shift=twins[4])
    want = torch.autograd.grad(ref, twins, dy)
    _assert_within_limit(out.detach(), ref.detach(), dtype, "y")
    for name, a, b_ in zip(("dx", "dgamma", "dbeta", "dscale", "dshift"),
                           got, want):
        assert a.dtype == b_.dtype, name
        if a.dtype == torch.bfloat16:
            # dx, and dscale, dshift returned in scale's bf16: one rounding
            _assert_within_limit(a, b_, torch.bfloat16, name)
        else:
            tol = GRAD_TOL[torch.float32] if name == "dx" else SUM_TOL
            torch.testing.assert_close(a, b_, atol=tol, rtol=tol,
                                       msg=lambda m: f"{name}: {m}")


def _group_norm_inputs(gen, dev, dtype, shape, film):
    b, c = shape[:2]
    x = (_randn(gen, dev, torch.float32, *shape)
         * torch.exp(0.5 * _randn(gen, dev, torch.float32, c,
                                  *([1] * (len(shape) - 2))))
         + 0.3).to(dtype)
    dy = _randn(gen, dev, dtype, *shape)
    gamma = 1 + 0.2 * _randn(gen, dev, torch.float32, c)
    beta = 0.1 * _randn(gen, dev, torch.float32, c)
    scale = shift = None
    if film:
        scale, shift = (0.3 * _randn(gen, dev, torch.float32, b, c)
                        for _ in range(2))
    return x, dy, gamma, beta, scale, shift


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,film,silu", [
    # the classifier's largest site (4 x 4096 elements a run, resident);
    # 4 x 16384 elements a run (256 KB of x and dy in bf16: streamed);
    # 7 x 7, three channels a group (runs off a 16-byte boundary); one
    # channel a group; 16 channels a group at 8 x 8 (more channels than
    # warps)
    ((32, 128, 64, 64), 32, True, True), ((2, 64, 128, 128), 16, False, True),
    ((3, 96, 7, 7), 32, True, True), ((2, 32, 9, 9), 32, True, False),
    ((4, 512, 8, 8), 32, True, True)])
@pytest.mark.parametrize("grads", ["dx", "all"])
def test_group_norm_backward_runs_and_forms(cuda_device, dtype, shape, groups,
                                            film, silu, grads):
    """The GroupNorm backward kernel, resident and streamed, in the dx-only
    form the guided samplers call and with every gradient: one launch,
    None for what was not asked, the rest within the limits of its twin;
    a run with one group's statistics taken from the next group breaks
    the dx limit."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x, dy, gamma, beta, scale, shift = _group_norm_inputs(
        gen, cuda_device, dtype, shape, film)
    _, mu, rstd = group_norm_fwd_plain(x, gamma, beta, scale, shift, groups,
                                       1e-5, silu)
    flags = dict(grad_affine=grads == "all", grad_film=grads == "all")
    args = (x, dy, gamma, beta, scale, shift, mu, rstd, groups, silu)
    reset_launch_counts()
    got = group_norm_bwd(*args, **flags)
    assert LAUNCHES == _launched(group_norm_bwd=1)
    want = group_norm_bwd_plain(*args, **flags)
    mu_bad, rstd_bad = mu.clone(), rstd.clone()
    mu_bad[:, 0], rstd_bad[:, 0] = mu[:, 1], rstd[:, 1]
    bad = group_norm_bwd(x, dy, gamma, beta, scale, shift, mu_bad, rstd_bad,
                         groups, silu, **flags)[0]
    torch.cuda.synchronize()
    _assert_within_limit(got[0], want[0], dtype, "dx")
    assert _limit_ratio(bad, want[0], dtype) > 1
    for name, a, b_ in zip(("dscale", "dshift", "dgamma", "dbeta"), got[1:],
                           want[1:]):
        if grads == "dx":
            assert a is None and b_ is None, name
        else:
            _assert_within_limit(a, b_, torch.float32, name, SUM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_dx_only_autograd_one_launch(cuda_device, dtype):
    """FusedGroupNormFunction as the guided samplers' frozen classifier
    runs it (x needs a gradient; gamma, beta and the FiLM terms do not):
    the backward is exactly one group_norm_bwd launch (no batch sum),
    returns None for every frozen input and the twin's dx."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    x, dy, gamma, beta, scale, shift = _group_norm_inputs(
        gen, cuda_device, dtype, (8, 128, 32, 32), True)
    xl = x.clone().requires_grad_(True)
    reset_launch_counts()
    out = FusedGroupNormFunction.apply(xl, gamma, beta, scale, shift, 32,
                                       1e-5, True)
    with torch.no_grad():
        grads = out.grad_fn.apply(dy)
    torch.cuda.synchronize()
    assert LAUNCHES == _launched(group_norm_fwd=1, group_norm_bwd=1)
    assert all(a is None for a in grads[1:])
    _, mu, rstd = group_norm_fwd_plain(x, gamma, beta, scale, shift, 32,
                                       1e-5, True)
    want = group_norm_bwd_plain(x, dy, gamma, beta, scale, shift, mu, rstd,
                                32, True, grad_affine=False, grad_film=False)
    _assert_within_limit(grads[0], want[0], dtype, "dx")


# (B, C_in, C_out, H, W) and the plan a bf16 call takes: the implicit GEMM
# (ops/conv_im2col.py::conv_plan) at whole-row tiles, split K (ADM's
# 1536 -> 768 8x8 level), a half-masked 128-channel tile (C_out 192),
# tiles of 64 columns of a 512-wide row, ragged H (13 rows in bands of 8)
# and the 16-wide tile; the gather kernel at C_in % 16 != 0 or W % 8 != 0
CONV_SHAPES = [((2, 192, 192, 64, 64), "igemm"),
               ((3, 72, 100, 7, 9), "gather"),
               ((4, 256, 128, 16, 16), "igemm"),
               ((2, 64, 64, 1, 5), "gather"),
               ((32, 768, 768, 8, 8), "igemm"),
               ((32, 1536, 768, 8, 8), "igemm split"),
               ((32, 576, 192, 64, 64), "igemm"),
               ((1, 128, 128, 512, 512), "igemm"),
               ((2, 256, 128, 13, 32), "igemm")]


def _conv_f32_tol(c_in):
    """chip_smoke.py's float32 conv limit: two float32 sums of K = 9 C_in
    products in other orders differ by about sqrt(K) roundings, so the
    limit grows as sqrt(K) past 9 x 768."""
    return 2e-5 * max(1.0, 9 * c_in / (9 * 768)) ** 0.5


def _conv_inputs(gen, dev, dtype, b, c_in, c_out, h, w):
    x = _randn(gen, dev, dtype, b, c_in, h, w)
    wt = (_randn(gen, dev, torch.float32, c_out, c_in, 3, 3)
          / (9 * c_in) ** 0.5).to(dtype)
    bias = 0.1 * _randn(gen, dev, torch.float32, c_out)
    a = 1 + 0.3 * _randn(gen, dev, torch.float32, b, c_in)
    off = 0.3 * _randn(gen, dev, torch.float32, b, c_in)
    res = _randn(gen, dev, dtype, b, c_out, h, w)
    return x, wt, bias, a, off, res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,plan", CONV_SHAPES)
def test_conv_kernels_match_twins(cuda_device, no_tf32, dtype, shape, plan):
    got_plan = conv_plan(shape[0], shape[1], shape[2], shape[3], shape[4],
                         dtype)
    if dtype == torch.float32:
        assert got_plan.kernel == "float32"
    else:
        assert got_plan.kernel == plan.split()[0]
        assert got_plan.splits > 1 or not plan.endswith("split")
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x, wt, bias, a, off, res = _conv_inputs(gen, cuda_device, dtype, *shape)
    reset_launch_counts()
    pairs = {
        "conv": (conv3x3_im2col(x, wt, bias),
                 conv3x3_reference(x, wt, bias)),
        "conv, no bias": (conv3x3_im2col(x, wt),
                          conv3x3_reference(x, wt)),
        "fused": (conv3x3_fused_kernel(x, a, off, wt, bias, res),
                  fused_conv_reference(x, a, off, wt, bias, res)),
        "fused, no bias or residual": (
            conv3x3_fused_kernel(x, a, off, wt),
            fused_conv_reference(x, a, off, wt))}
    torch.cuda.synchronize()
    assert LAUNCHES == _launched(conv3x3=2, conv3x3_fused=2)
    for name, (got, want) in pairs.items():
        assert got.shape == (shape[0], shape[2], shape[3], shape[4])
        _assert_within_limit(got, want, dtype, name, _conv_f32_tol(shape[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_autograd_matches_twin(cuda_device, no_tf32, dtype):
    """conv3x3 and conv3x3_fused (kernel forwards; PyTorch's conv gradients
    in the dtype of x and w, the fused SiLU and affine in float32) against
    autograd of the twins, which take the conv gradients in float32. In
    bf16 the kernels' backward rounds the conv's input gradient to bf16
    before the SiLU derivative (as the JAX VJP does), one rounding the
    twin lacks: 6e-2 (1 + |twin|) covers it with a margin of about ten."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x, wt, bias, a, off, res = _conv_inputs(gen, cuda_device, dtype,
                                            2, 128, 64, 16, 16)
    g = _randn(gen, cuda_device, dtype, 2, 64, 16, 16)
    for fn, twin, args in (
            (conv3x3, conv3x3_reference, (x, wt, bias.to(dtype))),
            (conv3x3_fused, fused_conv_reference, (x, a, off, wt, bias, res))):
        leaves = [t.clone().requires_grad_(True) for t in args]
        twins = [t.clone().requires_grad_(True) for t in args]
        out = fn(*leaves)
        ref = twin(*twins)
        _assert_within_limit(out.detach(), ref.detach(), dtype, fn.__name__)
        got = torch.autograd.grad(out, leaves, g)
        want = torch.autograd.grad(ref, twins, g)
        for i, (p, q) in enumerate(zip(got, want)):
            assert p.dtype == q.dtype
            scale = float(q.float().abs().max())
            torch.testing.assert_close(
                p.float(), q.float(), rtol=GRAD_TOL[dtype],
                atol=GRAD_TOL[dtype] * max(scale, 1.0),
                msg=lambda m: f"{fn.__name__} grad {i}: {m}")


@pytest.mark.cuda
def test_conv_rejects_c_in_not_multiple_of_8(cuda_device):
    x = torch.zeros(1, 12, 4, 4, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        conv3x3_im2col(x, torch.zeros(8, 12, 3, 3, device=cuda_device))


# ------------------------------------------------- paths, GPU against CPU

def _tiny_adm(dev):
    from autodiffusion_tpu_torch.models import random_init_
    from autodiffusion_tpu_torch.models.unet import (EncoderUNetModel,
                                                     UNetModel)

    common = dict(model_channels=64, num_res_blocks=1, attention_ds=(2,),
                  channel_mult=(1, 2), num_head_channels=64)
    m = random_init_(UNetModel(in_channels=3, out_channels=6,
                               num_classes=10, **common), 0)
    c = random_init_(EncoderUNetModel(image_size=16, in_channels=3,
                                      out_channels=10, **common), 1)
    return (m.eval().to(dev).requires_grad_(False),
            c.eval().to(dev).requires_grad_(False))


@pytest.mark.cuda
def test_guided_ancestral_sampling_gpu_matches_cpu(cuda_device, no_tf32):
    """p_sample_loop with classifier guidance (head dim 64): the same x_T
    and per-step z on both devices; the GPU run launches the flash
    forward, dQ and dK/dV."""
    from autodiffusion_tpu_torch.samplers import (classifier_cond_fn,
                                                  p_sample_loop)
    from autodiffusion_tpu_torch.schedules import build_tables

    gen = torch.Generator().manual_seed(0)
    x_t = torch.randn(2, 3, 16, 16, generator=gen)
    z = torch.randn(3, 2, 3, 16, 16, generator=gen)
    y = torch.tensor([3, 7])
    outs = {}
    for dev in ("cpu", "cuda"):
        m, c = _tiny_adm(dev)
        yd = y.to(dev)
        reset_launch_counts()
        outs[dev] = p_sample_loop(
            lambda x, t, i: m(x, t, yd), (2, 3, 16, 16),
            build_tables([50, 400, 900]).to(dev), device=dev,
            cond_fn=classifier_cond_fn(c, yd, 2.0), noise=x_t,
            step_noise=z).cpu()
    assert LAUNCHES["flash_fwd"] and LAUNCHES["flash_bwd_dq"] \
        and LAUNCHES["flash_bwd_dkv"]
    scale = float(outs["cpu"].abs().max())
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=0,
                               atol=1e-3 * max(scale, 1.0))


@pytest.mark.cuda
def test_dpm_solver_sd_unet_gpu_matches_cpu(cuda_device, no_tf32):
    """DPM-Solver-2 over three steps of a tiny SD UNet (head dims 40 and
    80, the packed and token-major forwards) under classifier-free
    guidance."""
    from autodiffusion_tpu_torch.models import SDUNetModel, random_init_
    from autodiffusion_tpu_torch.samplers import (DiscreteNoiseSchedule,
                                                  cfg_eps_fn,
                                                  dpm_solver_sample_loop)
    from autodiffusion_tpu_torch.schedules import make_beta_schedule

    cfg = dict(in_channels=4, model_channels=320, out_channels=4,
               num_res_blocks=1, attention_ds=(1, 2), channel_mult=(1, 2),
               num_heads=8, context_dim=32)
    gen = torch.Generator().manual_seed(1)
    x_t = torch.randn(2, 4, 16, 16, generator=gen)
    ctx = torch.randn(2, 7, 32, generator=gen)
    unc = torch.randn(7, 32, generator=gen)
    times = torch.tensor([1.0, 0.6, 0.25, 1e-3])
    sched = DiscreteNoiseSchedule.from_betas(
        make_beta_schedule("sqrt_linear", 1000))
    outs = {}
    for dev in ("cpu", "cuda"):
        unet = random_init_(SDUNetModel(**cfg), 2).eval().to(dev)
        reset_launch_counts()
        outs[dev] = dpm_solver_sample_loop(
            cfg_eps_fn(unet, ctx.to(dev), unc.to(dev), 7.5), (2, 4, 16, 16),
            sched.to(dev), times.to(dev), device=dev, order=2,
            noise=x_t).cpu()
    assert LAUNCHES["flash_fwd_packed"] and LAUNCHES["flash_fwd"]
    scale = float(outs["cpu"].abs().max())
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=0,
                               atol=1e-3 * max(scale, 1.0))


@pytest.mark.cuda
def test_fid_evaluator_gpu_matches_cpu(cuda_device, no_tf32, tmp_path):
    """cal_metrics with synthesized Inception weights at 75 px on both
    devices: FID, IS and sFID within 1e-3 relative, precision and recall
    (float32 distances with TF32 off) equal."""
    import numpy as np

    from autodiffusion_tpu_torch.fid import (FIDEvaluator, FIDStats,
                                             load_fid_inception,
                                             make_inception_feature_fn,
                                             synthesize_pt_inception)

    path = str(tmp_path / "pt_inception.pth")
    torch.save(synthesize_pt_inception(3), path)
    rng = np.random.RandomState(2)
    refs = rng.randint(0, 256, (40, 64, 64, 3), dtype=np.uint8)
    samples = rng.randint(0, 200, (30, 64, 64, 3), dtype=np.uint8)
    got = {}
    for dev in ("cpu", "cuda"):
        fn = make_inception_feature_fn(load_fid_inception(path, device=dev),
                                       resize_to=75)
        ev = FIDEvaluator(fn, FIDEvaluator.stats_from_images(fn, refs, 16),
                          batch_size=16)
        pool3, _, spatial = ev.compute_activations(refs, want_spatial=True)
        assert pool3.device.type == dev
        ev.ref_stats_spatial = FIDStats.from_features(spatial.cpu().numpy())
        got[dev] = ev.cal_metrics(samples, ref_features=pool3)
    for key in ("fid", "inception_score", "sfid"):
        assert got["cuda"][key] == pytest.approx(got["cpu"][key],
                                                 rel=1e-3), key
    assert (got["cuda"]["precision"], got["cuda"]["recall"]) == \
        (got["cpu"]["precision"], got["cpu"]["recall"])


@pytest.mark.cuda
def test_training_step_bf16_switches_on_matches_twins(cuda_device,
                                                      monkeypatch):
    """One training step (loss, backward, AdamW + EMA) of a small
    class-conditional UNet on the card in bf16 with the three switches on,
    so the flash kernels, the GroupNorm backward in its every-gradient
    form (gamma, beta and the FiLM terms) and both conv kernels' backward
    run for trained weights; against the same step on the CPU twins
    (bf16, the same weights, batch, t and noise): the loss within 2e-2
    relative and the gradient norm within 5 % (bf16 activations summed in
    other orders), every parameter's gradient finite, and nonzero wherever
    the twins' is."""
    from autodiffusion_tpu_torch.models.unet import UNetModel
    from autodiffusion_tpu_torch.models import random_init_
    from autodiffusion_tpu_torch.schedules import build_base_tables
    from autodiffusion_tpu_torch.train import (create_train_state,
                                               make_train_step)

    for k, v in (("ADT_FUSED_NORM", "1"), ("ADT_IM2COL_CONV", "1"),
                 ("ADT_FUSED_CONV", "all")):
        monkeypatch.setenv(k, v)
    cfg = dict(in_channels=3, model_channels=64, out_channels=6,
               num_res_blocks=1, attention_ds=(2,), channel_mult=(1, 2),
               num_classes=10, num_head_channels=64, resblock_updown=True,
               use_new_attention_order=True, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(4, 3, 16, 16, generator=gen) * 2 - 1
    noise = torch.randn(4, 3, 16, 16, generator=gen)
    y, t = torch.tensor([1, 3, 5, 7]), torch.tensor([0, 10, 400, 999])
    state_dict = random_init_(UNetModel(**cfg), 3).state_dict()
    got = {}
    for dev in ("cpu", "cuda"):
        model = UNetModel(**cfg).to(dev).train()
        model.load_state_dict(state_dict)
        state = create_train_state(model, lr=1e-4)
        step = make_train_step(model, class_cond=True)
        reset_launch_counts()
        grads, metrics = step.grads_and_metrics(
            state, build_base_tables("cosine").to(dev),
            {"x": x.to(dev), "y": y.to(dev)}, t.to(dev),
            torch.ones(4, device=dev), noise=noise.to(dev))
        state.apply_gradients(grads)
        got[dev] = (dict(zip(state.names, (g.float().cpu() for g in grads))),
                    {k: v.float().cpu() for k, v in metrics.items()},
                    dict(LAUNCHES))
    gpu, cpu = got["cuda"], got["cpu"]
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "group_norm_fwd",
              "group_norm_bwd", "conv3x3", "conv3x3_fused"):
        assert gpu[2][k], f"{k} never launched"
    assert not any(cpu[2].values())
    assert float(gpu[1]["loss"]) == pytest.approx(float(cpu[1]["loss"]),
                                                  rel=2e-2)
    assert float(gpu[1]["grad_norm"]) == pytest.approx(
        float(cpu[1]["grad_norm"]), rel=5e-2)
    for name, g in gpu[0].items():
        assert torch.isfinite(g).all(), name
        if cpu[0][name].abs().max() > 0:
            assert g.abs().max() > 0, f"{name}: no gradient on the card"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,heads,t", [(96, 4, 256), (160, 8, 64),
                                       (192, 4, 256), (192, 4, 64)])
def test_sdpa_route_at_head_dims_without_a_kernel(cuda_device, dtype, d,
                                                  heads, t):
    """A head dim without a kernel (D = 96, SD's 160, sr-sample's 192)
    takes SDPA on the card, forward and backward, with no flash launch:
    routed_attention on the AttentionBlock's heads-first layout, its
    output and gradients against the plain twin's autograd, within the
    gradient limits."""
    from autodiffusion_tpu_torch.ops.flash_attention import (
        attention_route, routed_attention)

    for grad in (False, True):
        assert attention_route(t, t, d, heads, grad, cuda_device) == "sdpa"
    gen = torch.Generator(device=cuda_device).manual_seed(d + t)
    q, k, v, g = (_randn(gen, cuda_device, dtype, 2 * heads, t, d)
                  for _ in range(4))
    leaves = [z.clone().requires_grad_(True) for z in (q, k, v)]
    twins = [z.clone().requires_grad_(True) for z in (q, k, v)]
    reset_launch_counts()
    out = routed_attention(*leaves, heads)
    got = torch.autograd.grad(out, leaves, g)
    ref = flash_attention_reference(*twins)
    want = torch.autograd.grad(ref, twins, g)
    torch.cuda.synchronize()
    assert LAUNCHES == _launched()
    _assert_within_limit(out.detach(), ref.detach(), dtype, "o",
                         GRAD_TOL[torch.float32])
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), atol=GRAD_TOL[dtype],
                                   rtol=GRAD_TOL[dtype],
                                   msg=lambda m: f"d{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_block_d192_runs_sdpa(cuda_device, no_tf32, dtype):
    """sr-sample's AttentionBlock (768 channels, 4 heads: D = 192) on the
    card, which raised before SDPA took the head dims without a kernel:
    forward and input gradient against the same block on the CPU (the
    twin), float32 within 1e-3 of the scale, bf16 within 2e-2."""
    from autodiffusion_tpu_torch.models.unet import AttentionBlock

    torch.manual_seed(0)
    blk = AttentionBlock(768, num_heads=4)
    with torch.no_grad():
        blk.proj_out.weight.normal_(0, 0.05)
    x = torch.randn(2, 768, 16, 16)
    g = torch.randn_like(x)
    xc = x.clone().requires_grad_(True)
    want = blk(xc)
    want.backward(g)
    gpu = blk.to(cuda_device)
    xg = x.to(cuda_device, dtype).requires_grad_(True)
    reset_launch_counts()
    out = gpu(xg)
    out.backward(g.to(cuda_device, dtype))
    torch.cuda.synchronize()
    assert not LAUNCHES["flash_fwd"] and not LAUNCHES["flash_bwd_dq"]
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    for a, b in ((out.detach(), want.detach()), (xg.grad, xc.grad)):
        scale = float(b.abs().max())
        assert float((a.float().cpu() - b).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_flash_gate_table_is_read_and_can_be_switched_off(cuda_device,
                                                          monkeypatch):
    """A site in the gate's table takes SDPA (no flash launch);
    ADT_FLASH_GATE=0 puts it back on its kernel; every committed entry is
    routed to SDPA on the card and to its kernel with the gate off."""
    import sys

    from autodiffusion_tpu_torch.models.unet import AttentionBlock

    fa = sys.modules["autodiffusion_tpu_torch.ops.flash_attention"]
    for site in fa.FLASH_GATE_SDPA:
        monkeypatch.delenv("ADT_FLASH_GATE", raising=False)
        assert fa.attention_route(*site, cuda_device) == "sdpa"
        monkeypatch.setenv("ADT_FLASH_GATE", "0")
        assert fa.attention_route(*site, cuda_device) == "kernel"
    blk = AttentionBlock(128, num_head_channels=64).to(cuda_device)
    x = torch.randn(2, 128, 8, 8, device=cuda_device)
    monkeypatch.setattr(fa, "FLASH_GATE_SDPA",
                        frozenset({(64, 64, 64, 2, False)}))
    launched = {}
    for gate in ("1", "0"):
        monkeypatch.setenv("ADT_FLASH_GATE", gate)
        reset_launch_counts()
        with torch.no_grad():
            out = blk(x)
        torch.cuda.synchronize()
        launched[gate] = (LAUNCHES["flash_fwd"], out)
    assert launched["1"][0] == 0 and launched["0"][0] == 1
    torch.testing.assert_close(launched["1"][1], launched["0"][1],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [4, 16])
def test_group_norm_kernels_at_one_position(cuda_device, dtype, b):
    """The spatial_v2 classifier head's GroupNorm: [B, 2048, 1, 1], 32
    groups of 64 channels with one position each, SiLU: both kernels
    against their twins, and GroupNorm32 on the card launches them."""
    from autodiffusion_tpu_torch.models.nn import GroupNorm32

    gen = torch.Generator(device=cuda_device).manual_seed(b)
    shape = (b, 2048, 1, 1)
    x = (1.5 * _randn(gen, cuda_device, torch.float32, *shape) + 0.3).to(dtype)
    dy = _randn(gen, cuda_device, dtype, *shape)
    gamma = 1 + 0.2 * _randn(gen, cuda_device, torch.float32, 2048)
    beta = 0.1 * _randn(gen, cuda_device, torch.float32, 2048)
    reset_launch_counts()
    y, mu, rstd = group_norm_fwd(x, gamma, beta, None, None, 32, 1e-5, True)
    y_ref, mu_ref, rstd_ref = group_norm_fwd_plain(x, gamma, beta, None, None,
                                                   32, 1e-5, True)
    got = group_norm_bwd(x, dy, gamma, beta, None, None, mu_ref, rstd_ref,
                         32, True, grad_film=False)
    want = group_norm_bwd_plain(x, dy, gamma, beta, None, None, mu_ref,
                                rstd_ref, 32, True, grad_film=False)
    torch.cuda.synchronize()
    assert LAUNCHES == _launched(group_norm_fwd=1, group_norm_bwd=1)
    _assert_within_limit(y, y_ref, dtype, "y")
    _assert_within_limit(mu, mu_ref, torch.float32, "mu")
    _assert_within_limit(rstd, rstd_ref, torch.float32, "rstd")
    _assert_within_limit(got[0], want[0], dtype, "dx")
    for name, a, b_ in zip(("dgamma", "dbeta"), got[3:], want[3:]):
        _assert_within_limit(a, b_, torch.float32, name, SUM_TOL)
    norm = GroupNorm32(2048).to(cuda_device)
    reset_launch_counts()
    with torch.no_grad():
        norm(x, act="silu")
    assert LAUNCHES["group_norm_fwd"] == 1
