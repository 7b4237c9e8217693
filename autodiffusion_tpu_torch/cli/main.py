"""``adt-torch``: the command line of the PyTorch / CUDA port.

Port of autodiffusion_tpu/cli/main.py. Each command has the JAX CLI's
flags and defaults plus ``--device`` (cuda by default; without CUDA it
raises unless ``--device cpu`` is given):

  search      evolutionary timestep or joint timestep + architecture
              search for ADM models (search_imagenet64_classifier_
              guidance.py and its variants)
  sample      ADM samples with a searched schedule (and skipped layers),
              DDIM or ancestral, optionally classifier-guided
  evaluate    FID, IS, sFID and precision / recall of a sample ``.npz``
              against reference statistics or images
  ref-stats   FID reference statistics of an image ``.npz``
  search-sd   the Stable Diffusion latent search (sd/scripts/search_ea.py):
              classifier-free guided PLMS, DDIM or DPM-Solver, FID of the
              decoded images against COCO statistics

Checkpoints are guided-diffusion ``.pt`` state dicts and CompVis
``sd-v1-*.ckpt`` files (loaded with ``load_state_dict(strict=True)``), the
CLIP tokenizer a vocab.json / merges.txt pair, the Inception weights
pytorch_fid's ``pt_inception-2015-12-05`` ``.pth``, the reference
statistics an ``.npz`` of mu and sigma, sample and image arrays an
``.npz`` whose first array is uint8 [N, H, W, 3].
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import time

import numpy as np

from .. import resolve_device
from ..utils import logger
from ..utils.config import add_dict_to_argparser

__all__ = ["main", "cmd_search", "cmd_sample", "cmd_evaluate",
           "cmd_ref_stats", "cmd_search_sd"]


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

    if path.endswith(".msgpack"):
        raise ValueError(f"{path}: the port loads PyTorch .pt checkpoints "
                         "only (msgpack loading waits for ROADMAP queue 1 "
                         "item 8)")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    module.load_state_dict(sd, strict=True)


def _write_pngs(dir_: str, arr: np.ndarray) -> None:
    """One PNG per sample (*_generate_image.py / txt2img.py)."""
    from PIL import Image

    os.makedirs(dir_, exist_ok=True)
    for i, img in enumerate(arr):
        Image.fromarray(img).save(f"{dir_}/{i:06d}.png")
    logger.log(f"wrote {len(arr)} PNGs to {dir_}")


def _model_config(args, **kw):
    """The ADM ModelConfig of a command's model flags (+ ``kw``)."""
    from ..models import ModelConfig

    return ModelConfig(
        image_size=args.image_size, num_channels=args.num_channels,
        num_res_blocks=args.num_res_blocks,
        num_head_channels=args.num_head_channels,
        attention_resolutions=args.attention_resolutions,
        channel_mult=args.channel_mult, class_cond=args.class_cond,
        learn_sigma=args.learn_sigma, noise_schedule=args.noise_schedule,
        use_scale_shift_norm=args.use_scale_shift_norm,
        resblock_updown=args.resblock_updown,
        use_new_attention_order=args.use_new_attention_order,
        use_bf16=args.use_bf16, **kw)


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
    from ..models import ClassifierConfig, create_classifier, create_model
    from ..search import (EvolutionSearcher, JointSpace, TimestepSpace,
                          make_adm_fitness, parse_timestep_string,
                          progressive_skip_hook)

    dev = resolve_device(args.device)
    for flag in ("model_path", "inception_path", "ref_stats"):
        if not getattr(args, flag):
            raise ValueError(f"search needs --{flag}")
    logger.configure(args.save_dir or None)
    cfg = _model_config(args, dropout=args.dropout)
    # frozen: the search reads no weight gradient
    model = create_model(cfg, device=dev).requires_grad_(False)
    _load_state(model, args.model_path)

    classifier = None
    if args.classifier_path:
        classifier = create_classifier(
            ClassifierConfig.adm64(image_size=args.image_size),
            device=dev).requires_grad_(False)
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


def _sample_defaults():
    # the JAX CLI's sample flags (autodiffusion_tpu/cli/main.py:1223-1233)
    return dict(
        model_path="", classifier_path="", classifier_scale=1.0,
        use_timestep="", skip_layers="", use_ddim=True, num_samples=100,
        batch_size=100, seed=0, out="", class_cond=True, image_size=64,
        num_channels=192, num_res_blocks=3, num_head_channels=64,
        attention_resolutions="32,16,8", learn_sigma=True,
        noise_schedule="cosine", use_scale_shift_norm=True,
        resblock_updown=True, use_new_attention_order=True, use_bf16=True,
        channel_mult="", timestep_respacing="", save_png_dir="",
        device="cuda",
    )


def cmd_sample(args) -> int:
    """Samples of an ADM model with a searched schedule: DDIM or ancestral,
    optionally classifier-guided, optionally skipping layers per step
    (classifier_sample.py with the searched --use_timestep)."""
    import torch

    from ..models import (ClassifierConfig, create_classifier, create_model,
                          create_tables)
    from ..samplers import (ModelVarType, classifier_cond_fn,
                            ddim_sample_loop, p_sample_loop)
    from ..search import keep_masks_for, parse_timestep_string, to_uint8

    dev = resolve_device(args.device)
    if not args.model_path:
        raise ValueError("sample needs --model_path")
    if args.classifier_path and not args.class_cond:
        raise ValueError("classifier guidance requires --class_cond True "
                         "(the guidance log-prob is taken at the sampled "
                         "class labels)")
    cfg = _model_config(args, timestep_respacing=args.timestep_respacing)
    model = create_model(cfg, device=dev).requires_grad_(False)
    _load_state(model, args.model_path)
    use_ts = (parse_timestep_string(args.use_timestep)
              if args.use_timestep else None)
    tables = create_tables(cfg, use_ts).to(dev)

    keep = None
    if args.skip_layers:
        skips = ast.literal_eval(args.skip_layers)
        if len(skips) != tables.num_steps:
            raise ValueError(
                f"--skip_layers has {len(skips)} entries but the schedule "
                f"has {tables.num_steps} steps")
        keep = torch.from_numpy(keep_masks_for(skips, model.layer_num)) \
            .to(dev)

    classifier = None
    if args.classifier_path:
        classifier = create_classifier(
            ClassifierConfig.adm64(image_size=args.image_size),
            device=dev).requires_grad_(False)
        _load_state(classifier, args.classifier_path)

    # learn_sigma=False models emit 3 channels: FIXED_LARGE variance, the
    # reference create_gaussian_diffusion's fallback (script_util.py)
    var_type = (ModelVarType.LEARNED_RANGE if cfg.learn_sigma
                else ModelVarType.FIXED_LARGE)
    loop = ddim_sample_loop if args.use_ddim else p_sample_loop
    shape = (args.batch_size, 3, cfg.image_size, cfg.image_size)
    # labels, x_T and the per-step noise all come from one generator
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    all_imgs, all_labels = [], []
    n_done = 0
    t0 = time.time()
    while n_done < args.num_samples:
        y = (torch.randint(0, 1000, (args.batch_size,), generator=gen,
                           device=dev) if cfg.class_cond else None)

        def model_fn(x, t, i):
            return model(x, t, y, keep_mask=None if keep is None
                         else keep[i])

        cond_fn = (classifier_cond_fn(classifier, y, args.classifier_scale)
                   if classifier is not None else None)
        x0 = loop(model_fn, shape, tables, device=dev, generator=gen,
                  cond_fn=cond_fn, var_type=var_type)
        all_imgs.append(to_uint8(x0).cpu().numpy())
        if y is not None:
            all_labels.append(y.cpu().numpy())
        n_done += args.batch_size
        logger.log(f"created {n_done} samples ({time.time() - t0:.3f} s)")

    arr = np.concatenate(all_imgs)[: args.num_samples]
    out = (args.out or
           f"samples_{arr.shape[0]}x{arr.shape[1]}x{arr.shape[2]}x3.npz")
    if all_labels:
        np.savez(out, arr_0=arr,
                 arr_1=np.concatenate(all_labels)[: args.num_samples])
    else:
        np.savez(out, arr_0=arr)
    logger.log(f"saved to {out}")
    if args.save_png_dir:
        _write_pngs(args.save_png_dir, arr)
    return 0


def _first_array(path: str) -> np.ndarray:
    with np.load(path) as z:
        return z[z.files[0]]


def cmd_evaluate(args) -> int:
    """FID / IS / sFID / precision / recall of a sample .npz against
    reference statistics (an .npz of mu and sigma) or reference images."""
    from ..fid import (FIDEvaluator, FIDStats, load_fid_inception,
                       make_inception_feature_fn)

    dev = resolve_device(args.device)
    feature_fn = make_inception_feature_fn(
        load_fid_inception(args.inception_path, device=dev))
    arr = _first_array(args.sample_batch)
    has_mu = False
    if args.ref_stats.endswith(".npz"):
        with np.load(args.ref_stats) as z:
            has_mu = "mu" in z.files
    if has_mu:
        ref = FIDStats.load(args.ref_stats)
    else:
        ref = FIDEvaluator.stats_from_images(
            feature_fn, _first_array(args.ref_stats), args.batch_size)
    ref_spatial = (FIDStats.load(args.ref_stats_spatial)
                   if args.ref_stats_spatial else None)
    ev = FIDEvaluator(feature_fn, ref, ref_stats_spatial=ref_spatial,
                      batch_size=args.batch_size)
    # precision / recall compare the two feature sets themselves, so they
    # need the reference batch's features, not only its moments
    ref_features = None
    if args.ref_batch:
        ref_features, _, _ = ev.compute_activations(
            _first_array(args.ref_batch))
    print(json.dumps(ev.cal_metrics(arr, ref_features=ref_features)))
    return 0


def cmd_ref_stats(args) -> int:
    """FID reference statistics (and the sFID spatial ones) of an image
    .npz."""
    from ..fid import (FIDEvaluator, FIDStats, load_fid_inception,
                       make_inception_feature_fn)

    dev = resolve_device(args.device)
    feature_fn = make_inception_feature_fn(
        load_fid_inception(args.inception_path, device=dev))
    arr = _first_array(args.images)
    ev = FIDEvaluator(feature_fn, None, batch_size=args.batch_size)
    pool3, _, spatial = ev.compute_activations(arr, want_spatial=True)
    FIDStats.from_features(pool3.cpu().numpy()).save(args.out)
    if spatial is not None and args.spatial_out:
        FIDStats.from_features(spatial.cpu().numpy()).save(args.spatial_out)
        print(f"saved spatial (sFID) stats to {args.spatial_out}")
    print(f"saved reference stats for {arr.shape[0]} images to {args.out}")
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
    from ..search import (ContinuousTimeSpace, EvolutionSearcher,
                          TimestepSpace, make_sd_fitness)

    dev = resolve_device(args.device)
    for flag in ("ckpt", "clip_vocab", "clip_merges", "captions",
                 "inception_path", "ref_stats"):
        if not getattr(args, flag):
            raise ValueError(f"search-sd needs --{flag}")
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
    if args.sampler == "dpm_solver":
        space = ContinuousTimeSpace.uniform_grid(args.time_step + 1)
    else:
        space = TimestepSpace(1000, args.time_step)
    searcher = EvolutionSearcher(
        space, fitness, population_num=args.population_num,
        select_num=args.select_num, mutation_num=args.mutation_num,
        crossover_num=args.crossover_num,
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
    p = sub.add_parser("sample", help="sample with a searched schedule")
    add_dict_to_argparser(p, _sample_defaults())
    p.set_defaults(fn=cmd_sample)
    p = sub.add_parser("evaluate", help="FID/IS of sample npz vs reference")
    add_dict_to_argparser(p, dict(sample_batch="", ref_stats="",
                                  ref_stats_spatial="", ref_batch="",
                                  inception_path="", batch_size=100,
                                  device="cuda"))
    p.set_defaults(fn=cmd_evaluate)
    p = sub.add_parser("ref-stats", help="precompute FID reference stats")
    add_dict_to_argparser(p, dict(images="", out="ref_stats.npz",
                                  spatial_out="", inception_path="",
                                  batch_size=100, device="cuda"))
    p.set_defaults(fn=cmd_ref_stats)
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
