"""The port's CUDA kernels on the GPU, held against their plain twins.

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
"""

import pytest
import torch

from autodiffusion_tpu_torch.ops.flash_attention import (
    LAUNCHES, flash_attention, flash_attention_reference, flash_bwd_dkv,
    flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain, flash_fwd,
    flash_fwd_plain, reset_launch_counts)

GRAD_TOL = {torch.float32: 3e-5, torch.bfloat16: 6e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(gen, dev, dtype, *shape):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


def _assert_within_limit(got, want, dtype, name):
    assert got.dtype == want.dtype, name
    diff = (got.float() - want.float()).abs()
    a = want.float().abs()
    if dtype == torch.float32:
        lim = 2e-5 * (1 + a)
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
    assert LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1,
                        "flash_bwd_dkv": 1}


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
    assert LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1,
                        "flash_bwd_dkv": 1}
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
