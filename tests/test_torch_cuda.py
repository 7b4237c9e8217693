"""The port's CUDA kernels on the GPU, held against their plain twins:
flash attention (forward at D <= 128 and D = 512, the packed small-head-dim
forward, dQ, dK/dV), the fused GroupNorm (forward, backward) and the 3x3
convolutions (im2col, fused norm-act-conv).

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
convolutions with TF32 off.
"""

import pytest
import torch

from autodiffusion_tpu_torch.ops.conv_im2col import (
    conv3x3, conv3x3_fused, conv3x3_fused_kernel, conv3x3_im2col,
    conv3x3_reference, fused_conv_reference)
from autodiffusion_tpu_torch.ops.flash_attention import (
    LAUNCHES, flash_attention, flash_attention_reference, flash_bwd_dkv,
    flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain, flash_fwd,
    flash_fwd_packed, flash_fwd_packed_plain, flash_fwd_plain,
    multihead_attention, reset_launch_counts)
from autodiffusion_tpu_torch.ops.fused_norm import (
    FusedGroupNormFunction, group_norm_bwd, group_norm_bwd_plain,
    group_norm_fwd, group_norm_fwd_plain, group_norm_reference)

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
@pytest.mark.parametrize("t,s,d", [(1024, 1024, 80), (1024, 77, 80),
                                   (300, 200, 80), (700, 650, 512),
                                   (64, 130, 512)])
def test_forward_new_head_dims_match_twin(cuda_device, dtype, t, s, d):
    """flash_fwd at D = 80 (the SD 32x32 level) and D = 512 (the VAE
    mid-block, the flash_fwd_wide kernel); a run with one 64-key tile
    left out breaks the limit."""
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
    (2, 5, 64, 100, 70), (1, 4, 32, 64, 64), (2, 2, 16, 50, 40)])
def test_packed_forward_matches_twin(cuda_device, dtype, b, heads, d, t, s):
    """flash_fwd_packed on the token-major layout against its twin; runs
    with the heads shifted by one (a wrong head offset), with one 64-key
    tile left out, and (D = 40 in bf16) with the padding lanes read from
    memory instead of zeroed all break the limit."""
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
    if d % 16 and dtype == torch.bfloat16:
        # (the float32 kernel runs on the CUDA cores and pads nothing)
        faults.append(flash_fwd_packed(q, k, v, heads, _raw_pad=True)[0])
    for bad in faults:
        assert _limit_ratio(bad, o_ref, dtype) > 1


@pytest.mark.cuda
def test_multihead_attention_routes_each_head_dim(cuda_device):
    """D = 40 to the packed kernel, D = 80 to flash_fwd, D = 512 to
    flash_fwd_wide, D = 160 to plain PyTorch; each against the plain
    twin."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for heads, d, stem in ((8, 40, "flash_fwd_packed"), (8, 80, "flash_fwd"),
                           (1, 512, "flash_fwd_wide"), (8, 160, None)):
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


CONV_SHAPES = [(2, 192, 192, 64, 64), (3, 72, 100, 7, 9),
               (4, 256, 128, 16, 16), (2, 64, 64, 1, 5), (32, 768, 768, 8, 8)]


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
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_kernels_match_twins(cuda_device, no_tf32, dtype, shape):
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
        _assert_within_limit(got, want, dtype, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_autograd_matches_twin(cuda_device, no_tf32, dtype):
    """conv3x3 (kernel forward, PyTorch conv gradients) and conv3x3_fused
    (kernel forward, autograd of the twin) against autograd of the twins."""
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
