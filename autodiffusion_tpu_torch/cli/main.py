"""``adt-torch``: the command line of the PyTorch / CUDA port.

Port of autodiffusion_tpu/cli/main.py. Two commands so far, each with the
JAX CLI's flags and defaults plus ``--device`` (cuda by default; without
CUDA it raises unless ``--device cpu`` is given):

  search      evolutionary timestep or joint timestep + architecture
              search for ADM models (search_imagenet64_classifier_
              guidance.py and its variants)
  search-sd   the Stable Diffusion latent search (sd/scripts/search_ea.py):
              classifier-free guided PLMS or DDIM, FID of the decoded
              images against COCO statistics

Checkpoints are guided-diffusion ``.pt`` state dicts and CompVis
``sd-v1-*.ckpt`` files (loaded with ``load_state_dict(strict=True)``), the
CLIP tokenizer a vocab.json / merges.txt pair, the Inception weights
pytorch_fid's ``pt_inception-2015-12-05`` ``.pth``, the reference
statistics an ``.npz`` of mu and sigma.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .. import resolve_device
from ..utils import logger
from ..utils.config import add_dict_to_argparser

__all__ = ["main", "cmd_search", "cmd_search_sd"]


def _search_defaults():
    # search_imagenet64_classifier_guidance.py:600-618 + model flags
    return dict(
        model_path="", classifier_path="", ref_stats="", save_dir="",
        classifier_scale=1.0, use_ddim=True, time_step=4,
        num_samples=5000, batch_size=100, max_epochs=10, select_num=10,
        population_num=50, m_prob=0.25, crossover_num=15, mutation_num=25,
        use_ddim_init_x=True, seed=0, candidate_chunk=4, resume=False,
        max_device_batch=0,   # 0 = no cap (see search/fitness.py)
        use_dynamic_unet=False, index_step=0, max_prun=0.1, min_prun=0.0,
        init_timesteps="", inception_path="", class_cond=True,
        image_size=64, num_channels=192, num_res_blocks=3,
        num_head_channels=64, attention_resolutions="32,16,8",
        learn_sigma=True, noise_schedule="cosine", use_scale_shift_norm=True,
        resblock_updown=True, use_new_attention_order=True, use_bf16=True,
        dropout=0.0, channel_mult="", device="cuda",
    )


def _load_state(module, path: str) -> None:
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    module.load_state_dict(sd, strict=True)


def _maybe_resume_ea(searcher, args) -> None:
    """Resume an interrupted EA from save_dir/ea_state.json (--resume)."""
    path = searcher.checkpoint_path
    if not args.resume:
        if path and os.path.exists(path):
            logger.log(f"note: {path} exists from a previous run; pass "
                       "--resume True to continue it (starting fresh "
                       "will overwrite it)")
        return
    if not path:
        raise ValueError("--resume needs --save_dir (the EA checkpoint "
                         "lives at save_dir/ea_state.json)")
    if not os.path.exists(path):
        logger.log(f"--resume: no checkpoint at {path}, starting fresh")
        return
    searcher.load(path)


def cmd_search(args) -> int:
    from ..fid import FIDStats, inception_apply, load_fid_inception
    from ..models import (ClassifierConfig, ModelConfig, create_classifier,
                          create_model)
    from ..search import (EvolutionSearcher, JointSpace, TimestepSpace,
                          make_adm_fitness, parse_timestep_string,
                          progressive_skip_hook)

    dev = resolve_device(args.device)
    for flag in ("model_path", "inception_path", "ref_stats"):
        if not getattr(args, flag):
            raise ValueError(f"search needs --{flag}")
    logger.configure(args.save_dir or None)
    cfg = ModelConfig(
        image_size=args.image_size, num_channels=args.num_channels,
        num_res_blocks=args.num_res_blocks,
        num_head_channels=args.num_head_channels,
        attention_resolutions=args.attention_resolutions,
        channel_mult=args.channel_mult, class_cond=args.class_cond,
        learn_sigma=args.learn_sigma, noise_schedule=args.noise_schedule,
        use_scale_shift_norm=args.use_scale_shift_norm,
        resblock_updown=args.resblock_updown,
        use_new_attention_order=args.use_new_attention_order,
        use_bf16=args.use_bf16, dropout=args.dropout)
    model = create_model(cfg, device=dev)
    _load_state(model, args.model_path)

    classifier = None
    if args.classifier_path:
        classifier = create_classifier(
            ClassifierConfig.adm64(image_size=args.image_size), device=dev)
        _load_state(classifier, args.classifier_path)

    inception = load_fid_inception(args.inception_path, device=dev)
    ref = FIDStats.load(args.ref_stats)

    joint = bool(args.use_dynamic_unet)
    fitness = make_adm_fitness(
        model=model, image_size=cfg.image_size,
        feature_fn=lambda imgs: inception_apply(inception, imgs),
        ref_stats=ref, num_samples=args.num_samples,
        batch_size=args.batch_size, base_schedule=cfg.noise_schedule,
        classifier=classifier, classifier_scale=args.classifier_scale,
        num_classes=1000 if cfg.class_cond else None,
        use_ddim=args.use_ddim, learn_sigma=cfg.learn_sigma, joint=joint,
        candidate_chunk=args.candidate_chunk, seed=args.seed,
        max_device_batch=args.max_device_batch or None, device=dev)

    hook = None
    if joint:
        space = JointSpace(cfg.diffusion_steps, model.layer_num,
                           args.index_step, (0.0, 0.0))
        hook = progressive_skip_hook(args.max_prun, args.min_prun)
    else:
        search_space = None
        if args.init_timesteps:
            search_space = TimestepSpace.restricted_window(
                parse_timestep_string(args.init_timesteps), cfg.diffusion_steps)
        space = TimestepSpace(cfg.diffusion_steps, args.time_step,
                              search_space=search_space)
    searcher = EvolutionSearcher(
        space, fitness, population_num=args.population_num,
        select_num=args.select_num, mutation_num=args.mutation_num,
        crossover_num=args.crossover_num, m_prob=args.m_prob,
        max_epochs=args.max_epochs, use_ddim_init_x=args.use_ddim_init_x,
        use_ddim=args.use_ddim,
        checkpoint_path=(f"{args.save_dir}/ea_state.json"
                         if args.save_dir else None),
        on_epoch_start=hook)
    _maybe_resume_ea(searcher, args)
    t0 = time.time()
    best, fid = searcher.search()
    logger.log(f"total searching time = {(time.time() - t0) / 3600:.2f} hours")
    print(json.dumps({"best": list(best) if not joint else
                      {"timesteps": list(best[0]),
                       "skip_layers": [list(s) for s in best[1]]},
                      "fid": fid}))
    return 0


def _search_sd_defaults():
    # the JAX CLI's search-sd flags (autodiffusion_tpu/cli/main.py:1243-1251)
    return dict(
        ckpt="", clip_vocab="", clip_merges="", captions="",
        inception_path="", ref_stats="", save_dir="", sampler="plms",
        scale=7.5, H=512, W=512, time_step=4, num_samples=1000,
        batch_size=6, num_prompts=2000, max_epochs=10, select_num=10,
        population_num=50, m_prob=0.25, crossover_num=15, mutation_num=25,
        use_ddim_init_x=True, seed=0, candidate_chunk=2, use_bf16=True,
        resume=False, device="cuda",
    )


def _sd_stack(args, dev):
    """The three SD towers from a CompVis checkpoint, and the tokenizer."""
    from ..models import (ClipBPETokenizer, create_sd_models,
                          load_sd_checkpoint, split_sd_checkpoint)

    parts = split_sd_checkpoint(load_sd_checkpoint(args.ckpt))
    tok = ClipBPETokenizer.from_files(args.clip_vocab, args.clip_merges)
    towers = create_sd_models(args.use_bf16, device=dev)
    for module, part in zip(towers, parts):
        module.load_state_dict(part, strict=True)
    return (*towers, tok)


def cmd_search_sd(args) -> int:
    """Stable Diffusion latent search (sd/scripts/search_ea.py main)."""
    import torch

    from ..data import load_captions
    from ..fid import FIDStats, inception_apply, load_fid_inception
    from ..search import EvolutionSearcher, TimestepSpace, make_sd_fitness

    dev = resolve_device(args.device)
    for flag in ("ckpt", "clip_vocab", "clip_merges", "captions",
                 "inception_path", "ref_stats"):
        if not getattr(args, flag):
            raise ValueError(f"search-sd needs --{flag}")
    if args.sampler == "dpm_solver":
        raise NotImplementedError(
            "the dpm_solver sampler is not ported yet (ROADMAP.md, queue 1 "
            "item 10): use --sampler plms or ddim")
    if args.H != args.W or args.H % 8:
        raise ValueError(f"search-sd takes square images with a side "
                         f"divisible by 8; got {args.H}x{args.W}")
    logger.configure(args.save_dir or None)
    unet, vae, clip, tok = _sd_stack(args, dev)

    # the CLIP text tower runs once, into a context bank of the prompts
    captions = [c["caption"] for c in load_captions(args.captions,
                                                    limit=args.num_prompts)]
    ids = torch.from_numpy(tok(captions)).long().to(dev)
    with torch.no_grad():
        context_bank = torch.cat([clip(ids[i:i + 64])
                                  for i in range(0, len(captions), 64)])
        uncond = clip(torch.from_numpy(tok([""])).long().to(dev))[0]

    inception = load_fid_inception(args.inception_path, device=dev)
    fitness = make_sd_fitness(
        unet=unet, vae=vae, context_bank=context_bank, uncond_context=uncond,
        feature_fn=lambda imgs: inception_apply(inception, imgs),
        ref_stats=FIDStats.load(args.ref_stats),
        num_samples=args.num_samples, batch_size=args.batch_size,
        sampler=args.sampler, guidance_scale=args.scale,
        latent_hw=args.H // 8, candidate_chunk=args.candidate_chunk,
        seed=args.seed, device=dev)
    searcher = EvolutionSearcher(
        TimestepSpace(1000, args.time_step), fitness,
        population_num=args.population_num, select_num=args.select_num,
        mutation_num=args.mutation_num, crossover_num=args.crossover_num,
        m_prob=args.m_prob, max_epochs=args.max_epochs,
        use_ddim_init_x=args.use_ddim_init_x,
        checkpoint_path=(f"{args.save_dir}/ea_state.json"
                         if args.save_dir else None))
    _maybe_resume_ea(searcher, args)
    t0 = time.time()
    best, fid = searcher.search()
    logger.log(f"total searching time = {(time.time() - t0) / 3600:.2f} hours")
    print(json.dumps({"best": list(best), "fid": fid}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="adt-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("search", help="evolutionary ADM search")
    add_dict_to_argparser(p, _search_defaults())
    p.set_defaults(fn=cmd_search)
    p = sub.add_parser("search-sd", help="Stable Diffusion latent search")
    add_dict_to_argparser(p, _search_sd_defaults())
    p.set_defaults(fn=cmd_search_sd)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
