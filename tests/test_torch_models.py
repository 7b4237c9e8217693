"""ADM UNet and classifier of the PyTorch port against the JAX package.

Tiny configs (two levels, widths 32/64) with seeded random parameters, so
that the zero-initialised output projections carry signal too. Weights travel
flax -> port through ``models.convert`` and back through the JAX package's
own ``convert_unet`` / ``convert_classifier``; that round trip is exact.

Forward tolerance 2e-4 (absolute and relative), the JAX package's own
tolerance against guided-diffusion (tests/test_models.py): both sides run
float32 on the CPU, but the JAX AttentionBlock takes its einsum branch on
the CPU (q and k each scaled by D^-1/4) while the port scales the float32
logits by D^-1/2 after the dot, and the convolutions sum in other orders.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.models import EncoderUNetModel as JaxEncoder
from autodiffusion_tpu.models import UNetModel as JaxUNet
from autodiffusion_tpu.models.convert import convert_classifier, convert_unet
from autodiffusion_tpu_torch.models import (ClassifierConfig, ModelConfig,
                                            SDUNetModel, create_classifier,
                                            create_model, random_init_)
from autodiffusion_tpu_torch.models.convert import (
    classifier_state_dict_from_flax, unet_state_dict_from_flax)
from autodiffusion_tpu_torch.models.nn import GroupNorm32
from autodiffusion_tpu_torch.models.unet import (AttentionBlock,
                                                 EncoderUNetModel, UNetModel,
                                                 unet_layer_count)
from autodiffusion_tpu_torch.ops import (NHWC_LAUNCHES, is_nhwc,
                                         reset_launch_counts)
from autodiffusion_tpu_torch.samplers import classifier_cond_fn
from test_torch_package import one_torch_thread  # noqa: F401

# the module (the package re-exports a function of the same name)
_fa_module = importlib.import_module(
    "autodiffusion_tpu_torch.ops.flash_attention")
_unet_module = importlib.import_module("autodiffusion_tpu_torch.models.unet")

TOL = 2e-4
IMG = 16
COMMON = dict(model_channels=32, num_res_blocks=1, attention_ds=(2,),
              channel_mult=(1, 2), num_head_channels=16,
              use_scale_shift_norm=True, resblock_updown=True)


def _random_params(module, seed, *args):
    """Seeded numpy values in the shapes of ``module.init(*args)`` (traced
    with eval_shape, never run): kernels N(0, 1/fan_in), norm scales
    1 + N(0, 0.1^2), other leaves N(0, 0.05^2), so that every residual
    branch carries signal."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['kernel']"):
            std = 1.0 / np.sqrt(np.prod(shape[:-1]))
            return (rng.randn(*shape) * std).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name.endswith("['positional_embedding']"):
            return (rng.randn(*shape) / np.sqrt(shape[-1])).astype(np.float32)
        return (0.05 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _inputs(seed, b=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 3, IMG, IMG).astype(np.float32)
    t = np.array([17.0, 901.0][:b], np.float32)
    y = np.array([3, 7][:b])
    return x, t, y


def _unet_pair(new_order=True, num_classes=10, seed=0, **over):
    cfg = dict(COMMON, **over)
    jm = JaxUNet(out_channels=6, num_classes=num_classes,
                 use_new_attention_order=new_order, **cfg)
    args = [jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,))]
    if num_classes:
        args.append(jnp.zeros((1,), jnp.int32))
    params = _random_params(jm, seed, *args)
    pm = UNetModel(in_channels=3, out_channels=6, num_classes=num_classes,
                   use_new_attention_order=new_order, **cfg)
    pm.load_state_dict(unet_state_dict_from_flax(params), strict=True)
    return jm, params, pm.eval()


def _classifier_pair(seed=1):
    cfg = dict(COMMON, num_head_channels=32)
    jm = JaxEncoder(out_channels=10, use_new_attention_order=False,
                    pool="attention", **cfg)
    params = _random_params(jm, seed, jnp.zeros((1, IMG, IMG, 3)),
                            jnp.zeros((1,)))
    pm = EncoderUNetModel(image_size=IMG, in_channels=3, out_channels=10,
                          use_new_attention_order=False, **cfg)
    pm.load_state_dict(classifier_state_dict_from_flax(params), strict=True)
    return jm, params, pm.eval()


def _state_numpy(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("new_order", [True, False])
def test_unet_converter_round_trips_exactly(new_order):
    jm, params, pm = _unet_pair(new_order=new_order)
    back = convert_unet(_state_numpy(pm), jm)
    _assert_trees_equal(back, params)


def test_classifier_converter_round_trips_exactly():
    jm, params, pm = _classifier_pair()
    back = convert_classifier(_state_numpy(pm), jm)
    _assert_trees_equal(back, params)


def _jax_unet(jm, params, x, t, y, keep_mask=None):
    args = [jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t)]
    if y is not None:
        args.append(jnp.asarray(y))
    kw = {} if keep_mask is None else {"keep_mask": jnp.asarray(keep_mask)}
    out = jax.jit(jm.apply)(params, *args, **kw)
    return np.asarray(out).transpose(0, 3, 1, 2)


def _port_unet(pm, x, t, y, keep_mask=None):
    with torch.no_grad():
        return pm(torch.from_numpy(x), torch.from_numpy(t),
                  None if y is None else torch.from_numpy(y),
                  keep_mask=None if keep_mask is None
                  else torch.from_numpy(keep_mask)).numpy()


@pytest.mark.parametrize("mask", ["none", "vector", "per_sample"])
def test_unet_matches_jax_fp32(mask):
    jm, params, pm = _unet_pair()
    x, t, y = _inputs(2)
    keep = None
    if mask == "vector":
        keep = np.ones(pm.layer_num, np.float32)
        keep[[0, 3, pm.layer_num - 1]] = 0.0
    elif mask == "per_sample":
        keep = np.ones((2, pm.layer_num), np.float32)
        keep[0, [1, 4]] = 0.0
        keep[1, [2, pm.layer_num - 2]] = 0.0
    want = _jax_unet(jm, params, x, t, y, keep)
    got = _port_unet(pm, x, t, y, keep)
    assert got.dtype == np.float32 and got.shape == (2, 6, IMG, IMG)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    if keep is not None:
        # the mask really changes the output (the test is not vacuous)
        assert np.abs(got - _port_unet(pm, x, t, y)).max() > 1e-3


def test_unet_legacy_order_unconditional_matches_jax():
    jm, params, pm = _unet_pair(new_order=False, num_classes=None, seed=3,
                                attention_ds=(1, 2), resblock_updown=False,
                                use_scale_shift_norm=False)
    x, t, _ = _inputs(4)
    np.testing.assert_allclose(_port_unet(pm, x, t, None),
                               _jax_unet(jm, params, x, t, None),
                               atol=TOL, rtol=TOL)


def test_classifier_matches_jax_fp32():
    jm, params, pm = _classifier_pair()
    x, t, _ = _inputs(5)
    want = np.asarray(jax.jit(jm.apply)(
        params, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


SKIP_SETS = {"updown_attention": (1, 3, 11), "projections": (2, 7, 12),
             "middle": (0, 4, 5, 6, 13), "all": tuple(range(14))}


@pytest.mark.parametrize("which", list(SKIP_SETS))
def test_structural_skip_matches_jax_and_a_zero_keep_mask(which):
    """Layer ids left out of the graph: the JAX UNet's structural_skip
    gives the same output, and so does the port with those ids zeroed in
    the keep mask (the block's resample and channel projection stay)."""
    jm, params, pm = _unet_pair()
    assert pm.layer_num == 14
    skip = frozenset(SKIP_SETS[which])
    x, t, y = _inputs(7)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t),
                 torch.from_numpy(y), structural_skip=skip).numpy()
    want = np.asarray(jax.jit(jm.apply, static_argnames="structural_skip")(
        params, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t),
        jnp.asarray(y), structural_skip=skip)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    keep = np.ones(pm.layer_num, np.float32)
    keep[list(skip)] = 0.0
    np.testing.assert_allclose(got, _port_unet(pm, x, t, y, keep),
                               atol=1e-5, rtol=1e-5)
    assert np.abs(got - _port_unet(pm, x, t, y)).max() > 1e-3


def test_keep_mask_length_checked():
    _, _, pm = _unet_pair()
    x, t, y = _inputs(6)
    with pytest.raises(ValueError, match="keep_mask"):
        _port_unet(pm, x, t, y, np.ones(pm.layer_num + 1, np.float32))


# ------------------------------------------------------------ ADM-64 layout

def _adm64_attention_sites(monkeypatch, which):
    """(T, batch*heads, D) of every flash_attention call of one forward of
    the full-width ADM-64 model, run on the meta device (shapes only),
    with the flash gate off (ADT_FLASH_GATE=0: every site with a kernel on
    it)."""
    calls = []
    monkeypatch.setenv("ADT_FLASH_GATE", "0")

    def record(q, k, v):
        calls.append(tuple(q.shape))
        return torch.empty_like(q)

    monkeypatch.setattr(_fa_module, "flash_attention", record)
    with torch.device("meta"):
        if which == "unet":
            m = create_model(ModelConfig.adm64(), device="meta")
            x = torch.empty(1, 3, 64, 64)
            m(x, torch.zeros(1), torch.zeros(1, dtype=torch.long))
        else:
            m = create_classifier(ClassifierConfig.adm64(), device="meta")
            m(torch.empty(1, 3, 64, 64), torch.zeros(1))
    return m, [(t, n, d) for n, t, d in calls]


def test_adm64_layer_count_is_58(monkeypatch):
    m, _ = _adm64_attention_sites(monkeypatch, "unet")
    assert m.layer_num == 58
    assert unet_layer_count(3, (1, 2, 3, 4), (2, 4, 8), True) == 58


@pytest.mark.parametrize("which,want", [
    ("unet", {(1024, 6, 64): 7, (256, 9, 64): 7, (64, 12, 64): 8}),
    ("classifier", {(1024, 4, 64): 4, (256, 6, 64): 4, (64, 8, 64): 5}),
])
def test_adm64_attention_sites(monkeypatch, which, want):
    """Every self-attention site goes through ops.flash_attention, with the
    shapes and counts the kernel launch accounting relies on: 22 in the
    UNet and 13 in the classifier, all with head dim 64."""
    m, sites = _adm64_attention_sites(monkeypatch, which)
    got = {}
    for site in sites:
        got[site] = got.get(site, 0) + 1
    assert got == want
    assert len(sites) == sum(isinstance(mod, AttentionBlock)
                             for mod in m.modules())


# ----------------------------------------------- guided-diffusion key names

def test_state_dict_keys_match_guided_diffusion(reference_gd):
    """The port's module tree carries guided-diffusion's parameter names,
    so a published .pt loads with load_state_dict(strict=True)."""
    from guided_diffusion.unet import EncoderUNetModel as GDEncoder
    from guided_diffusion.unet import UNetModel as GDUNet

    gd = GDUNet(image_size=IMG, in_channels=3, model_channels=32,
                out_channels=6, num_res_blocks=1, attention_resolutions=(2,),
                dropout=0.0, channel_mult=(1, 2), num_classes=10,
                use_checkpoint=False, use_fp16=False, num_heads=1,
                num_head_channels=16, num_heads_upsample=-1,
                use_scale_shift_norm=True, resblock_updown=True,
                use_new_attention_order=True)
    _, _, pm = _unet_pair()
    assert set(pm.state_dict()) == set(gd.state_dict())
    pm.load_state_dict(gd.state_dict(), strict=True)

    gdc = GDEncoder(image_size=IMG, in_channels=3, model_channels=32,
                    out_channels=10, num_res_blocks=1,
                    attention_resolutions=(2,), channel_mult=(1, 2),
                    use_fp16=False, num_head_channels=32,
                    use_scale_shift_norm=True, resblock_updown=True,
                    pool="attention")
    _, _, pc = _classifier_pair()
    assert set(pc.state_dict()) == set(gdc.state_dict())
    pc.load_state_dict(gdc.state_dict(), strict=True)


# ------------------------------------------------ zero-initialised outputs

def _zero_names(sd):
    return {k for k, v in sd.items() if not torch.as_tensor(v).any()}


@pytest.mark.parametrize("which", ["unet", "classifier_adaptive",
                                   "classifier_attention"])
def test_fresh_model_zeroes_what_jax_init_zeroes(which):
    """A freshly built port model starts with the parameters the JAX
    package initialises to zero (``kernel_init=zero_init``, guided-
    diffusion's ``zero_module``: the ResBlock out-convs, the attention
    output projections, the UNet's final conv and the adaptive pool's
    conv) at zero. flax also starts every bias at zero where PyTorch draws
    them, so the weights' zero sets must be equal and every parameter the
    port zeroes must be zero in the JAX init too."""
    if which == "unet":
        jm = JaxUNet(out_channels=6, num_classes=10, **COMMON)
        tree = jax.jit(jm.init)(jax.random.key(0),
                                jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,)),
                                jnp.zeros((1,), jnp.int32))
        jax_sd = unet_state_dict_from_flax(tree)
        torch.manual_seed(0)
        port_sd = UNetModel(in_channels=3, out_channels=6, num_classes=10,
                            **COMMON).state_dict()
    else:
        pool = which.split("_")[1]
        cfg = dict(COMMON, num_head_channels=32)
        jm = JaxEncoder(out_channels=10, use_new_attention_order=False,
                        pool=pool, **cfg)
        tree = jax.jit(jm.init)(jax.random.key(0),
                                jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,)))
        jax_sd = classifier_state_dict_from_flax(tree)
        torch.manual_seed(0)
        port_sd = EncoderUNetModel(image_size=IMG, in_channels=3,
                                   out_channels=10, pool=pool,
                                   use_new_attention_order=False,
                                   **cfg).state_dict()
    assert set(port_sd) == set(jax_sd)
    port_zero, jax_zero = _zero_names(port_sd), _zero_names(jax_sd)

    def weights(names):
        return {n for n in names if not n.endswith("bias")}

    assert weights(port_zero) == weights(jax_zero)
    assert port_zero <= jax_zero
    assert weights(port_zero), "no zero-initialised weight"


def _norm_layouts(module):
    """The layout (is_nhwc) of every GroupNorm32 call's input, in call
    order, and the hooks that record them."""
    seen = []
    hooks = [m.register_forward_hook(lambda m, args, out:
                                     seen.append(is_nhwc(args[0])))
             for m in module.modules() if isinstance(m, GroupNorm32)]
    return seen, hooks


def _nchw_body(monkeypatch):
    """The models' entry left NCHW, so that their whole body runs NCHW:
    the layout the port ran before its models went channels-last."""
    monkeypatch.setattr(_unet_module, "to_channels_last",
                        lambda x, dtype: x.to(dtype))


@pytest.mark.parametrize("new_order", [True, False])
def test_unet_body_runs_channels_last(monkeypatch, new_order):
    """With the fused GroupNorm on (its twins on the CPU), every
    GroupNorm32 call of a UNet forward takes the NHWC route, the output is
    NCHW-contiguous, the same for NCHW and channels-last inputs, and
    equal to the model with its body run NCHW."""
    monkeypatch.setenv("ADT_FUSED_NORM", "1")
    pm = _unet_pair(new_order=new_order)[2]
    x, t, y = (torch.from_numpy(a) for a in _inputs(3))
    seen, hooks = _norm_layouts(pm)
    reset_launch_counts()
    with torch.no_grad():
        out = pm(x, t, y)
        out_cl = pm(x.contiguous(memory_format=torch.channels_last), t, y)
    for h in hooks:
        h.remove()
    assert len(seen) > 0 and all(seen)
    assert NHWC_LAUNCHES == {"group_norm_fwd": len(seen), "group_norm_bwd": 0}
    assert out.is_contiguous() and out.shape == (2, 6, IMG, IMG)
    assert torch.equal(out, out_cl)
    _nchw_body(monkeypatch)
    reset_launch_counts()
    with torch.no_grad():
        ref = pm(x, t, y)
    assert NHWC_LAUNCHES["group_norm_fwd"] == 0
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_classifier_guidance_runs_channels_last(monkeypatch):
    """The guidance's classifier forward and input gradient: every
    GroupNorm32 forward and backward on the NHWC route, the gradient
    NCHW-contiguous in x's dtype and equal to the NCHW body's."""
    monkeypatch.setenv("ADT_FUSED_NORM", "1")
    pm = _classifier_pair()[2]
    x, t, y = (torch.from_numpy(a) for a in _inputs(4))
    cond_fn = classifier_cond_fn(pm, y, scale=2.0)
    seen, hooks = _norm_layouts(pm)
    reset_launch_counts()
    grad = cond_fn(x, t)
    for h in hooks:
        h.remove()
    assert len(seen) > 0 and all(seen)
    assert NHWC_LAUNCHES == {"group_norm_fwd": len(seen),
                             "group_norm_bwd": len(seen)}
    assert grad.is_contiguous() and grad.dtype == x.dtype
    _nchw_body(monkeypatch)
    reset_launch_counts()
    ref = cond_fn(x, t)
    assert NHWC_LAUNCHES == {"group_norm_fwd": 0, "group_norm_bwd": 0}
    torch.testing.assert_close(grad, ref, atol=1e-5, rtol=1e-5)


def test_sd_unet_stays_nchw(monkeypatch):
    """SD's UNet keeps NCHW: none of its GroupNorm32 calls takes the NHWC
    route."""
    monkeypatch.setenv("ADT_FUSED_NORM", "1")
    m = random_init_(SDUNetModel(
        in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
        attention_ds=(1, 2), channel_mult=(1, 2), num_heads=2,
        transformer_depth=1, context_dim=16), 1)
    gen = torch.Generator().manual_seed(5)
    seen, hooks = _norm_layouts(m)
    reset_launch_counts()
    with torch.no_grad():
        out = m(torch.randn(2, 4, 8, 8, generator=gen),
                torch.tensor([10.0, 700.0]),
                torch.randn(2, 5, 16, generator=gen))
    for h in hooks:
        h.remove()
    assert len(seen) > 0 and not any(seen)
    assert NHWC_LAUNCHES == {"group_norm_fwd": 0, "group_norm_bwd": 0}
    assert out.is_contiguous()
