"""The port's latent-diffusion first stage and class embedder against the
JAX package's, on the CPU at a tiny size in float32.

``VQModelInterface`` (Encoder without the doubled moments, quant_conv,
the nearest-codebook ``VectorQuantizer``, post_quant_conv, Decoder) and
``ClassEmbedder``: weights from the port's ``state_dict()`` through the
JAX package's converters (convert_vq), inputs made with numpy from a seed.
Tolerance: 1e-4 of the output's largest |value| (float32 sums over a conv
stack in another order). Codebook indices are equal wherever the two
nearest codes' distances are more than 1e-6 apart (relative); nearer
than that, float32 rounding may pick either.

Also: the flax <-> port converters of the VQ tree, both directions,
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from autodiffusion_tpu.models import ClassEmbedder as JaxClassEmbedder
from autodiffusion_tpu.models import VQModelInterface as JaxVQ
from autodiffusion_tpu.models.sd_convert import convert_vq
from autodiffusion_tpu_torch.models import (ClassEmbedder, VQModelInterface,
                                            random_init_)
from autodiffusion_tpu_torch.models.convert import (flax_tree_from_vae,
                                                    vq_state_dict_from_flax)
from test_torch_package import one_torch_thread  # noqa: F401

TINY_VQ = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_at_ds=(2,),
               z_channels=3, embed_dim=3, n_embed=64)
REL = 1e-4
TIE = 1e-6


def _np_state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _nhwc(a):
    return jnp.asarray(np.asarray(a).transpose(0, 2, 3, 1))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())


def _pair(seed=3):
    m = random_init_(VQModelInterface(**TINY_VQ), seed).eval()
    fm = JaxVQ(**TINY_VQ)
    return m, fm, convert_vq(_np_state(m), fm, prefix="")


def _distances(h, emb):
    flat = np.asarray(h, np.float64).transpose(0, 2, 3, 1).reshape(-1,
                                                                 h.shape[1])
    return ((flat[:, None, :] - emb[None].astype(np.float64)) ** 2).sum(-1)


def test_vq_encode_decode_match_jax():
    m, fm, params = _pair()
    x = np.random.RandomState(4).randn(2, 3, 16, 16).astype(np.float32)
    with torch.no_grad():
        h = m.encode(torch.from_numpy(x))
        dec = m.decode(h)
        dec_nq = m.decode(h, force_not_quantize=True)
        codes = m.quantize.codes(h).numpy().reshape(-1)
    jh = fm.apply(params, _nhwc(x), method=fm.encode)
    assert h.shape == (2, 3, 8, 8)
    _close(h.numpy(), _nchw(jh))
    # JAX's codes: the codebook row each quantized vector is
    emb = params["params"]["quantize"]["embedding"]
    jq = np.asarray(fm.apply(params, jh, method=lambda mdl, z:
                             mdl.quantize(z))).reshape(-1, 3)
    jcodes = np.abs(jq[:, None, :] - emb[None]).sum(-1).argmin(-1)
    d = np.sort(_distances(h.numpy(), emb), axis=-1)
    tie = (d[:, 1] - d[:, 0]) <= TIE * d[:, 1]
    assert len(set(codes.tolist())) > 4, "too few codes to test the lookup"
    assert (codes == jcodes)[~tie].all()
    if not tie.any():
        _close(dec.numpy(), _nchw(fm.apply(params, jh, method=fm.decode)))
    _close(dec_nq.numpy(), _nchw(fm.apply(
        params, jh, True, method=fm.decode)))


def test_vq_codes_are_the_nearest_rows_under_bf16():
    """A bf16 latent is quantized in float32 and returned in bf16."""
    m, _, _ = _pair()
    h = torch.randn(1, 3, 4, 4, generator=torch.Generator().manual_seed(0))
    q = m.quantize(h.to(torch.bfloat16))
    assert q.dtype == torch.bfloat16
    emb = m.quantize.embedding.weight.detach().numpy()
    want = _distances(h.to(torch.bfloat16).float().numpy(), emb).argmin(-1)
    np.testing.assert_array_equal(
        m.quantize.codes(h.to(torch.bfloat16)).numpy().reshape(-1), want)


def test_vq_tree_converters_round_trip():
    """Port -> flax tree equals convert_vq of the same state dict, bit for
    bit; a JAX-initialised VQ tree -> the port's state dict loads strictly
    and comes back to the same tree."""
    m, fm, params = _pair()
    got = flax_tree_from_vae(m)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, params)
    init = fm.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)))
    fresh = VQModelInterface(**TINY_VQ)
    fresh.load_state_dict(vq_state_dict_from_flax(init), strict=True)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
        flax_tree_from_vae(fresh), jax.device_get(init))


def test_class_embedder_matches_jax():
    m = random_init_(ClassEmbedder(16, 10), 5)
    y = np.array([0, 3, 9, 3])
    with torch.no_grad():
        got = m(torch.from_numpy(y)).numpy()
    want = JaxClassEmbedder(embed_dim=16, n_classes=10).apply(
        {"params": {"embedding": {"embedding":
                                  _np_state(m)["embedding.weight"]}}},
        jnp.asarray(y))
    assert got.shape == (4, 1, 16)
    _close(got, want)
