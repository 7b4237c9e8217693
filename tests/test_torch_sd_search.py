"""The port's Stable Diffusion search pipeline on the CPU: its pieces
against the JAX package's (prompt_window and sd_decode_to_uint8, exact),
a tiny-model make_sd_fitness driven by the EvolutionSearcher through the
Python API, and the ``search-sd`` flags against the JAX CLI's."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.cli import main as jax_cli
from autodiffusion_tpu.search.sd_pipelines import \
    prompt_window as jax_prompt_window
from autodiffusion_tpu.search.sd_pipelines import \
    sd_decode_to_uint8 as jax_decode
from autodiffusion_tpu_torch.cli.main import build_parser
from autodiffusion_tpu_torch.fid import FIDStats
from autodiffusion_tpu_torch.models import (AutoencoderKL, SDUNetModel,
                                            random_init_)
from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts
from autodiffusion_tpu_torch.search import (EvolutionSearcher, TimestepSpace,
                                            make_sd_fitness, prompt_window,
                                            sd_decode_to_uint8)
from autodiffusion_tpu_torch.utils import logger
from test_torch_package import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n,chunk,batch_idx,n_prompts", [
    (8, 2, 0, 5), (8, 2, 3, 5), (12, 3, 7, 100), (6, 1, 2, 4)])
def test_prompt_window_matches_jax(n, chunk, batch_idx, n_prompts):
    np.testing.assert_array_equal(
        prompt_window(n, chunk, batch_idx, n_prompts).numpy(),
        np.asarray(jax_prompt_window(n, chunk, batch_idx, n_prompts)))


def test_decode_to_uint8_matches_jax():
    """The same decode (a fixed map of the latents to [-1.2, 1.2], so the
    clamp is exercised) on both sides; the port is NCHW in, NHWC out."""
    z = np.random.RandomState(0).randn(2, 3, 4, 5).astype(np.float32)

    def decode(zz, lib):
        return 1.2 * lib.tanh(zz * 3.0)

    got = sd_decode_to_uint8(lambda zz: decode(zz, torch),
                             torch.from_numpy(z))
    want = jax_decode(lambda p, zz: decode(zz, jnp), None,
                      jnp.asarray(z.transpose(0, 2, 3, 1)))
    assert got.dtype == torch.uint8 and got.shape == (2, 4, 5, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


TINY_UNET = dict(in_channels=4, model_channels=32, out_channels=4,
                 num_res_blocks=1, attention_ds=(1, 2), channel_mult=(1, 2),
                 num_heads=2, context_dim=16)


@pytest.mark.parametrize("sampler", ["plms", "ddim"])
def test_tiny_search_runs_through_the_python_api(tmp_path, sampler):
    """make_sd_fitness (tiny UNet and VAE, random weights, a stub feature
    map) under the EvolutionSearcher: finite FIDs >= 0 for every
    candidate, and no kernel launch on the CPU."""
    logger.configure(str(tmp_path))
    unet = random_init_(SDUNetModel(**TINY_UNET), 0).eval()
    vae = random_init_(AutoencoderKL(ch=32, ch_mult=(1, 2),
                                     num_res_blocks=1), 1).eval()
    gen = torch.Generator().manual_seed(2)
    bank = torch.randn(5, 7, 16, generator=gen)
    proj = torch.randn(3, 8, generator=gen)

    def features(imgs):                     # uint8 [N, 16, 16, 3]
        x = imgs.float().mean(dim=(1, 2)) / 255.0
        return {"pool3": torch.tanh(x @ proj)}

    ref = FIDStats(np.zeros(8), np.eye(8))
    fitness = make_sd_fitness(
        unet=unet, vae=vae, context_bank=bank, uncond_context=bank[0] * 0,
        feature_fn=features, ref_stats=ref, num_samples=4, batch_size=2,
        sampler=sampler, latent_hw=8, candidate_chunk=2, feature_dim=8,
        device="cpu")
    searcher = EvolutionSearcher(
        TimestepSpace(1000, 3), fitness, population_num=4,
        select_num=2, mutation_num=1, crossover_num=1, max_epochs=1)
    reset_launch_counts()
    best, fid = searcher.search()
    fids = list(searcher.vis_dict.values())
    assert len(fids) >= 4 and all(math.isfinite(f) and f >= 0 for f in fids)
    assert len(best) == 3 and fid == min(fids)
    assert set(LAUNCHES.values()) == {0}


def test_search_sd_defaults_equal_the_jax_cli(monkeypatch):
    seen = {}
    monkeypatch.setattr(jax_cli, "cmd_search_sd",
                        lambda args: seen.update(vars(args)) or 0)
    assert jax_cli.main(["search-sd"]) == 0
    ours = vars(build_parser().parse_args(["search-sd"]))
    for d in (seen, ours):
        d.pop("fn")
    assert ours.pop("device") == "cuda"
    assert ours == seen
