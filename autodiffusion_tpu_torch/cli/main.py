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
  txt2img     Stable Diffusion text-to-image with a searched schedule
              (sd/scripts/txt2img_fid.py; --prompt_mask the ablation of
              txt2img_prompt_mask.py)
  img2img     Stable Diffusion image-to-image (sd/scripts/img2img.py)
  ldm-sample  latent-diffusion sampling, unconditional or class-
              conditional, VQ or KL first stage (sd/scripts/
              sample_diffusion.py)
  inpaint     latent inpainting of image + mask pairs (sd/scripts/
              inpaint.py)
  convert     a torch checkpoint -> the JAX package's msgpack params
              (a CompVis SD .ckpt -> the three-tower params directory)
  sr-sample   super-resolution sampling of low-res base samples
              (scripts/super_res_sample.py)
  train       train or fine-tune an ADM UNet (train_util.py TrainLoop and
              its OFA variants), or with --sr_small_size a SuperResModel
              on (low, high) pairs (scripts/super_res_train.py)
  train-classifier  the noisy guidance classifier
              (scripts/classifier_train.py)
  nll         bits/dim over a dataset (scripts/image_nll.py)
  selftest    the FID pipeline's checks against a pytorch_fid Inception
              ``.pth`` (digest, strict loads, features against an
              independent torch mirror, FID against float64 numpy / scipy)

Checkpoints are guided-diffusion ``.pt`` state dicts (what ``train``
writes), the JAX package's ``.msgpack`` param trees (what ``adt train``
writes, read without flax), CompVis ``sd-v1-*.ckpt`` and LDM ``.ckpt``
files (loaded with ``load_state_dict(strict=True)``) and the SD params
directory ``convert --preset sd`` writes (either package's), the
CLIP tokenizer a vocab.json / merges.txt pair, the Inception weights
pytorch_fid's ``pt_inception-2015-12-05`` ``.pth``, the reference
statistics an ``.npz`` of mu and sigma, sample and image arrays an
``.npz`` whose first array is uint8 [N, H, W, 3].

``sample``, ``train`` and ``train-classifier`` run data parallel under
``torchrun --nproc_per_node=N`` (one process per GPU, NCCL; gloo with
``--device cpu``): ``--batch_size`` is the global batch, every rank draws
the same global randomness and keeps its rows, so the result is that of
one process. Only rank 0 writes files and logs. The other commands run
one process.
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

DATA_PARALLEL = ("sample", "train", "train-classifier")

__all__ = ["main", "cmd_search", "cmd_sample", "cmd_evaluate",
           "cmd_ref_stats", "cmd_search_sd", "cmd_train", "cmd_sr_sample",
           "cmd_selftest",
           "cmd_train_classifier", "cmd_nll", "cmd_txt2img", "cmd_img2img",
           "cmd_ldm_sample", "cmd_inpaint", "cmd_convert",
           "img2img_latents", "inpaint_condition", "inpaint_composite"]


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
    """Weights of ``module`` (the UNet or the classifier) from a ``.pt``
    state dict or a JAX ``.msgpack`` param tree."""
    from ..utils.checkpoint import flax_state_dict, load_checkpoint

    if path.endswith(".msgpack"):
        sd = flax_state_dict(path, module)
    else:
        sd = load_checkpoint(path)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    module.load_state_dict(sd, strict=True)


def _data_parallel(dev):
    """Join torchrun's process group, if the command runs under it:
    (device, mesh, sharder). Each process takes its GPU (LOCAL_RANK), the
    other ranks' logger writes nothing, and the sharder takes this rank's
    rows of a global batch and averages over the ranks (in one process:
    all the rows, and no reduction)."""
    import torch

    from ..parallel import data_sharder, make_mesh, rank, setup_dist

    setup_dist(device=dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    if rank() != 0:
        logger.configure(None, log_to_stdout=False, formats=[])
    mesh = make_mesh()
    return dev, mesh, data_sharder(mesh)


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
    (classifier_sample.py with the searched --use_timestep). Data
    parallel, each rank samples its rows of every global batch (labels,
    x_T and each step's noise drawn at the global shape) and rank 0
    gathers and writes them."""
    import torch

    from ..models import (ClassifierConfig, create_classifier, create_model,
                          create_tables)
    from ..parallel import all_gather_host, barrier, rank
    from ..samplers import (ModelVarType, classifier_cond_fn,
                            ddim_sample_loop, p_sample_loop)
    from ..search import keep_masks_for, parse_timestep_string, to_uint8

    dev = resolve_device(args.device)
    if not args.model_path:
        raise ValueError("sample needs --model_path")
    dev, mesh, shard = _data_parallel(dev)
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
        y_rows = shard(y)

        def model_fn(x, t, i):
            return model(x, t, y_rows, keep_mask=None if keep is None
                         else keep[i])

        cond_fn = (classifier_cond_fn(classifier, y_rows,
                                      args.classifier_scale)
                   if classifier is not None else None)
        x0 = loop(model_fn, shape, tables, device=dev, generator=gen,
                  cond_fn=cond_fn, var_type=var_type, shard_fn=shard)
        imgs = all_gather_host(to_uint8(x0).cpu().numpy())
        all_imgs.append(imgs.reshape((-1,) + imgs.shape[-3:]))
        if y is not None:
            all_labels.append(y.cpu().numpy())
        n_done += args.batch_size
        logger.log(f"created {n_done} samples ({time.time() - t0:.3f} s)")

    if rank() != 0:
        barrier("sample")
        return 0
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
    barrier("sample")
    return 0


def _sr_sample_defaults():
    # the JAX CLI's sr-sample flags (autodiffusion_tpu/cli/main.py:1235-1241)
    return dict(
        model_path="", base_samples="", large_size=256, small_size=64,
        num_channels=192, num_res_blocks=2, channel_mult="", learn_sigma=True,
        noise_schedule="linear", class_cond=True, use_ddim=True,
        num_samples=16, batch_size=16, seed=0, out="", use_bf16=True,
        device="cuda",
    )


def cmd_sr_sample(args) -> int:
    """Super-resolution sampling (scripts/super_res_sample.py): each
    batch of --batch_size low-res base samples (the first array of
    --base_samples, uint8 [N, h, w, 3]; labels from its arr_1, else class
    0) conditions a SuperResModel at --large_size over the model's full
    schedule, DDIM or ancestral; writes arr_0 uint8 [N, L, L, 3] to --out.
    The weights come from a guided-diffusion ``.pt`` (the plain UNet's
    keys) or the ``.msgpack`` of ``adt train --sr_small_size``; without
    --model_path the model keeps its seeded initialisation."""
    import torch

    from ..models import ModelConfig, create_sr_model, create_tables
    from ..samplers import ModelVarType, ddim_sample_loop, p_sample_loop
    from ..search import to_uint8

    dev = resolve_device(args.device)
    if not args.base_samples:
        raise ValueError("sr-sample needs --base_samples (an .npz of uint8 "
                         "[N, h, w, 3] images)")
    cfg = ModelConfig(image_size=args.large_size,
                      num_channels=args.num_channels,
                      num_res_blocks=args.num_res_blocks,
                      channel_mult=args.channel_mult,
                      learn_sigma=args.learn_sigma,
                      noise_schedule=args.noise_schedule,
                      class_cond=args.class_cond, use_bf16=args.use_bf16)
    with np.load(args.base_samples) as z:
        low = z[z.files[0]][: args.num_samples]
        labels = z["arr_1"] if "arr_1" in z.files else None
    torch.manual_seed(args.seed)
    sr = create_sr_model(cfg, large_size=args.large_size,
                         small_size=args.small_size,
                         device=dev).requires_grad_(False)
    if args.model_path:
        _load_state(sr, args.model_path)
    n = low.shape[0]
    low = torch.from_numpy(low.astype(np.float32) / 127.5 - 1.0) \
        .permute(0, 3, 1, 2).contiguous().to(dev)
    y = None
    if cfg.class_cond:
        y = (torch.from_numpy(np.asarray(labels[:n])).long()
             if labels is not None else torch.zeros(n, dtype=torch.long))
        y = y.to(dev)
    tables = create_tables(cfg).to(dev)
    loop = ddim_sample_loop if args.use_ddim else p_sample_loop
    var_type = (ModelVarType.LEARNED_RANGE if cfg.learn_sigma
                else ModelVarType.FIXED_LARGE)
    bs = min(args.batch_size, n)
    outs = []
    t0 = time.time()
    for j in range(0, n, bs):
        low_j = low[j:j + bs]
        y_j = None if y is None else y[j:j + bs]

        def model_fn(x, t, i, low_j=low_j, y_j=y_j):
            return sr(x, t, low_j, y_j)

        gen = torch.Generator(device=dev).manual_seed(args.seed + j)
        x0 = loop(model_fn, (low_j.shape[0], 3, args.large_size,
                             args.large_size), tables, device=dev,
                  generator=gen, var_type=var_type)
        outs.append(to_uint8(x0).cpu().numpy())
        logger.log(f"super-resolved {j + low_j.shape[0]}/{n} "
                   f"({time.time() - t0:.3f} s)")
    out = args.out or "sr_samples.npz"
    np.savez(out, arr_0=np.concatenate(outs))
    print(f"saved {n} super-resolved samples to {out}")
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
    """The three SD towers from ``--ckpt`` (a CompVis checkpoint or a
    params directory), and the tokenizer."""
    from ..models import ClipBPETokenizer, create_sd_models, load_sd_weights

    parts = load_sd_weights(args.ckpt)
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


def _derive_low_res(it, scale: int):
    """SR conditioning by exact area downsampling of each batch (upstream
    guided-diffusion's load_superres_data F.interpolate(mode="area"), a
    block mean at an integer scale): adds "low_res" [B, H / scale, W /
    scale, C] to each numpy batch."""
    for b in it:
        x = b["x"]
        n, h, w, c = x.shape
        b = dict(b)
        b["low_res"] = x.reshape(n, h // scale, scale,
                                 w // scale, scale, c).mean(axis=(2, 4))
        yield b


def _train_data_iter(data_dir: str, *, batch_size: int, image_size: int,
                     class_cond: bool, seed: int = 0, lq_dir=None,
                     small_size=None):
    """Training batches (numpy [B, H, W, C] in [-1, 1]) from an image
    folder (data/images.py ``load_data``, with ``lq_dir`` its low-res
    partners as "low_res" [B, small_size, small_size, C]) or from a uint8
    [N, H, W, C] ``.npy`` served by the C++ loader (data/native_loader.py),
    whose class labels for a class-conditional run come from a sibling
    ``<stem>_labels.npy``."""
    from ..data import load_data

    if not data_dir:
        raise ValueError("unspecified data directory (--data_dir)")
    if data_dir.endswith(".npy"):
        if lq_dir:
            raise ValueError("--lq_dir pairs need an image folder "
                             "--data_dir (the npy bulk loader has no "
                             "paired-file mode; omit --lq_dir to derive "
                             "low_res by area downsampling)")
        from ..data.native_loader import NativeNpyLoader

        labels = data_dir[:-len(".npy")] + "_labels.npy"
        if class_cond and not os.path.exists(labels):
            raise ValueError(
                f"class_cond training from an npy needs labels at {labels} "
                "(one int per image)")
        return NativeNpyLoader(data_dir, labels if class_cond else None,
                               batch_size=batch_size, crop=image_size,
                               seed=seed)
    return load_data(data_dir=data_dir, batch_size=batch_size,
                     image_size=image_size, class_cond=class_cond, seed=seed,
                     lq_dir=lq_dir, small_size=small_size)


def _train_defaults():
    # the JAX CLI's train flags (autodiffusion_tpu/cli/main.py:1294-1309)
    return dict(
        data_dir="", save_dir="", resume_checkpoint="", lr=1e-4,
        weight_decay=0.0, lr_anneal_steps=0, batch_size=16, microbatch=0,
        ema_rate="0.9999", log_interval=10, save_interval=10000,
        schedule_sampler="uniform", ofa_mode="", max_steps=0, seed=0,
        image_size=64, num_channels=192, num_res_blocks=3,
        num_head_channels=64, attention_resolutions="32,16,8",
        class_cond=True, learn_sigma=True, noise_schedule="cosine",
        dropout=0.1, resblock_updown=True, use_scale_shift_norm=True,
        use_new_attention_order=True, use_bf16=True, channel_mult="",
        sr_small_size=0, lq_dir="", device="cuda",
    )


def _seed_sr_from_base(model, path: str) -> bool:
    """super_res_train.py:38-49: a base model's ``.pt`` (3 input channels)
    seeds a SuperResModel, its input conv zero-padded to the 6 channels
    and a 6-channel output head cut to 3 where the SR model does not learn
    sigma. True when ``path`` was such a file (then loaded), False for a
    SuperResModel checkpoint of its own (left to the resume)."""
    import torch

    from ..utils.checkpoint import load_checkpoint

    sd = load_checkpoint(path)
    w = sd.get("input_blocks.0.0.weight")
    if w is None or w.shape[1] != 3:
        return False
    sd["input_blocks.0.0.weight"] = torch.cat([w, torch.zeros_like(w)], 1)
    logger.log("input shape change: "
               f"{tuple(sd['input_blocks.0.0.weight'].shape)}")
    out = model.out[2].weight.shape[0]
    if sd["out.2.weight"].shape[0] != out:
        sd["out.2.weight"] = sd["out.2.weight"][:out]
        sd["out.2.bias"] = sd["out.2.bias"][:out]
    model.load_state_dict(sd, strict=True)
    return True


def _local_batch(batch_size: int, mesh) -> int:
    """This rank's rows of a global batch of ``batch_size``."""
    if batch_size % mesh.shape["data"]:
        raise ValueError(f"--batch_size {batch_size} does not divide over "
                         f"the {mesh.shape['data']} data-parallel ranks")
    return batch_size // mesh.shape["data"]


def _state_tensors(state) -> list:
    """The model, EMA copies and optimizer state of a TrainState: what
    rank 0 broadcasts so that every rank starts from its state."""
    import torch

    return [state.model, list(state.ema_params),
            [v for st in state.optimizer.state.values()
             for v in st.values() if torch.is_tensor(v)]]


def cmd_train(args) -> int:
    """Train or fine-tune an ADM UNet (scripts/image_train.py and
    train_util.py's TrainLoop, with the OFA respacing curricula), or with
    --sr_small_size a SuperResModel at --image_size on (low, high) pairs
    (scripts/super_res_train.py): low_res from --lq_dir partner files, or
    derived from each batch by area downsampling. The model trains in
    train mode (dropout on); bf16 compute over float32 parameters under
    --use_bf16. Data parallel, every rank reads the same global batches,
    trains on its rows and applies the update of the whole batch."""
    import torch

    from ..models import create_model, create_sr_model, create_tables
    from ..parallel import barrier, rank, replicate
    from ..samplers import ModelVarType
    from ..train import (TrainLoop, create_named_schedule_sampler,
                         create_train_state, make_train_step,
                         ofa_random_select_tables_fn, ofa_tables_fn,
                         resume_train_state)

    dev = resolve_device(args.device)
    if args.ofa_mode not in ("", "random_section", "random_select"):
        raise ValueError(f"unknown --ofa_mode {args.ofa_mode!r} (random_"
                         "section or random_select)")
    dev, mesh, shard = _data_parallel(dev)
    local = _local_batch(args.batch_size, mesh)
    cfg = _model_config(args, dropout=args.dropout)
    sr_mode = args.sr_small_size > 0
    if sr_mode and cfg.image_size % args.sr_small_size:
        raise ValueError(
            f"--image_size {cfg.image_size} must be a multiple of "
            f"--sr_small_size {args.sr_small_size}")
    data = _train_data_iter(
        args.data_dir, batch_size=args.batch_size, image_size=cfg.image_size,
        class_cond=cfg.class_cond, seed=args.seed,
        lq_dir=(args.lq_dir or None) if sr_mode else None,
        small_size=args.sr_small_size if sr_mode else None)
    if sr_mode and not args.lq_dir:
        data = _derive_low_res(data, cfg.image_size // args.sr_small_size)
    if rank() == 0:
        logger.configure(args.save_dir or None)
    torch.manual_seed(args.seed)
    model = (create_sr_model(cfg, large_size=cfg.image_size,
                             small_size=args.sr_small_size, device=dev)
             if sr_mode else create_model(cfg, device=dev)).train()
    ckpt = args.resume_checkpoint
    # a base model's .pt seeds an SR model (before the EMA copies are made)
    seeded = bool(sr_mode and ckpt.endswith(".pt")
                  and _seed_sr_from_base(model, ckpt))
    state = create_train_state(
        model, lr=args.lr, weight_decay=args.weight_decay,
        ema_rates=tuple(float(r) for r in str(args.ema_rate).split(",")),
        lr_anneal_steps=args.lr_anneal_steps)
    if ckpt and not seeded:
        resume_train_state(state, ckpt)
    replicate(mesh, _state_tensors(state))
    # learn_sigma False -> FIXED_LARGE, the reference default
    # (script_util.py:415-453 create_gaussian_diffusion)
    var_type = (ModelVarType.LEARNED_RANGE if cfg.learn_sigma
                else ModelVarType.FIXED_LARGE)
    step = make_train_step(
        model, class_cond=cfg.class_cond, var_type=var_type,
        microbatches=max(1, local // (args.microbatch or local)),
        data_sharder=shard)
    grad_fn = tables_fn = None
    if args.ofa_mode == "random_section":
        tables_fn = ofa_tables_fn(cfg.noise_schedule, cfg.diffusion_steps)
    elif args.ofa_mode == "random_select":
        tables_fn = ofa_random_select_tables_fn(cfg.noise_schedule,
                                                cfg.diffusion_steps)
        # the sandwich accumulates gradients over four schedules an update
        grad_fn = step.grads_and_metrics
    logger.log(f"training {sum(p.numel() for p in model.parameters())} "
               f"parameters on {dev}")
    loop = TrainLoop(
        state=state, step_fn=step, grad_fn=grad_fn, data=data,
        schedule_sampler=create_named_schedule_sampler(
            args.schedule_sampler, cfg.diffusion_steps),
        tables=create_tables(cfg), tables_fn=tables_fn,
        batch_size=args.batch_size, lr_anneal_steps=args.lr_anneal_steps,
        log_interval=args.log_interval, save_interval=args.save_interval,
        save_dir=args.save_dir, seed=args.seed, data_sharder=shard)
    loop.run_loop(max_steps=args.max_steps or None)
    barrier("train")
    return 0


def _train_classifier_defaults():
    # the JAX CLI's train-classifier flags (cli/main.py:1311-1322)
    return dict(
        data_dir="", save_dir="", resume_checkpoint="", noised=True,
        iterations=150000, lr=3e-4, weight_decay=0.05, anneal_lr=False,
        batch_size=4, log_interval=10, save_interval=10000, seed=0,
        num_classes=1000, noise_schedule="cosine", diffusion_steps=1000,
        image_size=64, classifier_width=128, classifier_depth=2,
        classifier_attention_resolutions="32,16,8",
        classifier_use_scale_shift_norm=True, classifier_resblock_updown=True,
        classifier_pool="attention", classifier_use_bf16=True,
        device="cuda",
    )


def cmd_train_classifier(args) -> int:
    """Train the noisy guidance classifier (scripts/classifier_train.py):
    noised inputs at uniform t, cross-entropy, AdamW, top-1 / top-5; data
    parallel as ``train``."""
    import torch

    from ..data import load_data
    from ..models import ClassifierConfig, create_classifier
    from ..parallel import barrier, rank, replicate
    from ..schedules import build_base_tables
    from ..train import (create_train_state, make_classifier_train_step,
                         resume_train_state)
    from ..train.loop import batch_to_device
    from ..utils.checkpoint import save_checkpoint

    dev = resolve_device(args.device)
    dev, mesh, shard = _data_parallel(dev)
    data = load_data(data_dir=args.data_dir, batch_size=args.batch_size,
                     image_size=args.image_size, class_cond=True,
                     random_crop=True)
    if rank() == 0:
        logger.configure(args.save_dir or None)
    cfg = ClassifierConfig(
        image_size=args.image_size, classifier_width=args.classifier_width,
        classifier_depth=args.classifier_depth,
        classifier_attention_resolutions=args.classifier_attention_resolutions,
        classifier_use_scale_shift_norm=args.classifier_use_scale_shift_norm,
        classifier_resblock_updown=args.classifier_resblock_updown,
        classifier_pool=args.classifier_pool,
        classifier_use_bf16=args.classifier_use_bf16)
    torch.manual_seed(args.seed)
    clf = create_classifier(cfg, num_classes=args.num_classes,
                            device=dev).train()
    state = create_train_state(
        clf, lr=args.lr, weight_decay=args.weight_decay, ema_rates=(),
        lr_anneal_steps=args.iterations if args.anneal_lr else 0)
    if args.resume_checkpoint:
        resume_train_state(state, args.resume_checkpoint)
    replicate(mesh, _state_tensors(state))
    step = make_classifier_train_step(clf, noised=args.noised,
                                      data_sharder=shard)
    tables = build_base_tables(args.noise_schedule,
                               args.diffusion_steps).to(dev)
    logger.log(f"training {sum(p.numel() for p in clf.parameters())} "
               f"parameters on {dev}")
    rng = np.random.RandomState(args.seed)

    def save(i):
        if rank() != 0:
            return
        save_checkpoint(f"{args.save_dir}/model{i:06d}.pt", clf.state_dict())
        save_checkpoint(f"{args.save_dir}/opt{i:06d}.pt",
                        state.optimizer.state_dict())

    i = state.step
    while i < args.iterations:
        t0 = time.time()
        batch = batch_to_device(next(data), dev)
        t = torch.from_numpy(rng.randint(0, tables.num_steps,
                                         args.batch_size)).long().to(dev)
        gen = torch.Generator(device=dev).manual_seed(
            int(rng.randint(2 ** 31)))
        _, metrics = step(state, tables, batch, t, gen)
        i = state.step
        metrics.pop("per_example_loss", None)
        logger.logkv("step", i)
        logger.logkv("samples", i * args.batch_size)
        logger.logkv_mean("step_time", time.time() - t0)
        for k, v in metrics.items():
            logger.logkv_mean(k, float(v))
        if i % args.log_interval == 0:
            logger.dumpkvs()
        if args.save_dir and args.save_interval and \
                i % args.save_interval == 0:
            save(i)
    if args.save_dir and (not args.save_interval
                          or i % args.save_interval != 0):
        save(i)
    barrier("train-classifier")
    return 0


def _nll_defaults():
    # the JAX CLI's nll flags (cli/main.py:1324-1328)
    return dict(
        model_path="", data_dir="", num_samples=100, batch_size=10,
        image_size=64, num_channels=192, num_res_blocks=3, learn_sigma=True,
        noise_schedule="cosine", class_cond=True, device="cuda",
    )


def cmd_nll(args) -> int:
    """Bits/dim over a dataset (scripts/image_nll.py): the full
    variational bound over the model's 1000-step schedule, float32. The
    model is ``train``'s ADM-64 architecture at the given widths, so the
    command reads what ``train`` writes at its defaults."""
    import torch

    from ..data import load_data
    from ..models import ModelConfig, create_model, create_tables
    from ..samplers import ModelVarType
    from ..train import calc_bpd_loop
    from ..train.loop import batch_to_device

    dev = resolve_device(args.device)
    if not args.model_path:
        raise ValueError("nll needs --model_path")
    cfg = ModelConfig.adm64(
        image_size=args.image_size, num_channels=args.num_channels,
        num_res_blocks=args.num_res_blocks, learn_sigma=args.learn_sigma,
        noise_schedule=args.noise_schedule, class_cond=args.class_cond,
        use_bf16=False, dropout=0.0)
    data = load_data(data_dir=args.data_dir, batch_size=args.batch_size,
                     image_size=cfg.image_size, class_cond=cfg.class_cond,
                     deterministic=True)
    model = create_model(cfg, device=dev).requires_grad_(False)
    _load_state(model, args.model_path)
    tables = create_tables(cfg).to(dev)
    var_type = (ModelVarType.LEARNED_RANGE if cfg.learn_sigma
                else ModelVarType.FIXED_LARGE)
    totals = []
    t0 = time.time()
    for i in range(args.num_samples // args.batch_size):
        batch = batch_to_device(next(data), dev)
        y = batch.get("y")
        gen = torch.Generator(device=dev).manual_seed(i)
        out = calc_bpd_loop(tables, lambda x_t, t: model(x_t, t, y),
                            batch["x"], gen, var_type=var_type)
        totals.extend(out["total_bpd"].cpu().numpy().tolist())
        logger.log(f"batch {i}: mean bpd {np.mean(totals):.4f} "
                   f"({time.time() - t0:.3f} s)")
    print(json.dumps({"bpd": float(np.mean(totals))}))
    return 0


def _txt2img_defaults():
    # the JAX CLI's txt2img flags (autodiffusion_tpu/cli/main.py:1253-1259)
    return dict(
        ckpt="", clip_vocab="", clip_merges="", prompt="", from_file="",
        sampler="plms", scale=7.5, H=512, W=512, steps=50, timesteps="",
        prompt_mask="", n_samples=4, seed=42, out="", save_png_dir="",
        use_bf16=True, device="cuda",
    )


def _encode_prompts(clip, tok, prompts, dev):
    import torch

    return clip(torch.from_numpy(tok(prompts)).long().to(dev))


def cmd_txt2img(args) -> int:
    """Text-to-image with an optional searched schedule
    (sd/scripts/txt2img_fid.py): prompts in batches of --n_samples, each
    batch's classifier-free guidance against one empty-prompt row; PLMS,
    DDIM or multistep DPM-Solver (--timesteps then the time knots), an
    optional per-step guidance mask (--prompt_mask, PLMS and DDIM)."""
    import torch

    from ..samplers import (DiscreteNoiseSchedule, ModelVarType, cfg_eps_fn,
                            ddim_sample_loop, dpm_solver_sample_loop,
                            plms_sample_loop)
    from ..schedules import (build_sd_tables, make_beta_schedule,
                             make_ddim_timesteps)
    from ..search import sd_decode_to_uint8

    dev = resolve_device(args.device)
    prompts = [args.prompt] * args.n_samples if args.prompt else []
    if args.from_file:
        with open(args.from_file) as f:
            prompts = [line.strip() for line in f if line.strip()]
    if not prompts:
        print("no prompts: pass --prompt or a non-empty --from_file "
              "(writing a 0-sample npz would only fail downstream)")
        return 1
    # the guidance mask of txt2img_prompt_mask.py: steps with mask 0 run
    # unconditional only; the DPM-Solver loop passes no step index
    if args.prompt_mask and args.sampler == "dpm_solver":
        print("--prompt_mask needs a stepwise sampler (plms/ddim); "
              "the dpm_solver loop has no per-step index")
        return 1
    steps = ast.literal_eval(args.timesteps) if args.timesteps else None
    n_steps = None
    if args.sampler == "dpm_solver":
        sched = DiscreteNoiseSchedule.from_betas(
            make_beta_schedule("sqrt_linear", 1000)).to(dev)
        times = torch.from_numpy(np.asarray(
            sorted(steps, reverse=True) if steps
            else np.linspace(1.0, 1e-3, args.steps + 1), np.float32)).to(dev)
    else:
        tables = build_sd_tables(
            steps or make_ddim_timesteps("uniform", args.steps, 1000)).to(dev)
        n_steps = tables.num_steps
    pmask = None
    if args.prompt_mask:
        pmask = torch.tensor(ast.literal_eval(args.prompt_mask),
                             dtype=torch.float32, device=dev)
        # checked against the built schedule: the uniform grid can hold
        # another count than --steps (make_ddim_timesteps)
        if pmask.shape[0] != n_steps:
            print(f"--prompt_mask has {pmask.shape[0]} entries but the "
                  f"schedule has {n_steps} steps")
            return 1
    unet, vae, clip, tok = _sd_stack(args, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bsz = max(1, args.n_samples)
    all_imgs = []
    t0 = time.time()
    with torch.no_grad():
        uc = _encode_prompts(clip, tok, [""], dev)[0]
        for start in range(0, len(prompts), bsz):
            ctx = _encode_prompts(clip, tok, prompts[start:start + bsz], dev)
            shape = (ctx.shape[0], 4, args.H // 8, args.W // 8)
            guided = cfg_eps_fn(unet, ctx, uc, args.scale, prompt_mask=pmask)
            if args.sampler == "dpm_solver":
                z = dpm_solver_sample_loop(guided, shape, sched, times,
                                           device=dev, generator=gen)
            elif args.sampler == "plms":
                z = plms_sample_loop(guided, shape, tables, device=dev,
                                     generator=gen)
            else:
                z = ddim_sample_loop(guided, shape, tables, device=dev,
                                     generator=gen, clip_denoised=False,
                                     var_type=ModelVarType.FIXED_SMALL)
            all_imgs.append(sd_decode_to_uint8(vae.decode, z).cpu().numpy())
            logger.log(f"created {start + ctx.shape[0]} samples "
                       f"({time.time() - t0:.3f} s)")
    imgs = np.concatenate(all_imgs)
    out = args.out or "txt2img_samples.npz"
    np.savez(out, arr_0=imgs)
    if args.save_png_dir:
        _write_pngs(args.save_png_dir, imgs)
    print(f"saved {len(imgs)} samples to {out}")
    return 0


def _img2img_defaults():
    # the JAX CLI's img2img flags (autodiffusion_tpu/cli/main.py:1261-1266)
    return dict(
        ckpt="", clip_vocab="", clip_merges="", prompt="", init_img="",
        strength=0.75, scale=7.5, H=512, W=512, steps=50, timesteps="",
        n_samples=2, seed=42, out="", save_png_dir="", use_bf16=True,
        device="cuda",
    )


def img2img_latents(guided, vae, x, tables, strength: float, n: int, *,
                    generator=None, posterior_noise=None, noise=None):
    """The latents img2img decodes (img2img.py semantics): the init image
    ``x`` [1, 3, H, W] in [-1, 1] encoded, one posterior draw a sample
    (``posterior_noise`` [n, 4, h, w], else from ``generator``; the
    reference samples the posterior, not its mean), scaled by 0.18215,
    diffused by ``q_sample`` to respaced index t_enc = max(1, int(strength
    K)) (one level past the last step decoded, as stochastic_encode
    gathers; clamped at the last grid point for strength 1) with
    ``noise`` (else from ``generator``), then DDIM over the first t_enc
    steps. ``tables`` must be on x's device."""
    import torch

    from ..models import SD_SCALE_FACTOR
    from ..samplers import ModelVarType, ddim_sample_loop, q_sample

    dev = x.device
    mean, logvar = vae.encode(x)
    shape = (n,) + tuple(mean.shape[1:])
    if posterior_noise is None:
        posterior_noise = torch.randn(shape, generator=generator, device=dev)
    z0 = (mean + torch.exp(0.5 * logvar) * posterior_noise) * SD_SCALE_FACTOR
    k = tables.num_steps
    t_enc = max(1, int(strength * k))
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=dev)
    z_enc = q_sample(tables, z0, min(t_enc, k - 1), noise)
    return ddim_sample_loop(guided, shape, tables.map(lambda a: a[..., :t_enc]),
                            device=dev, generator=generator,
                            clip_denoised=False,
                            var_type=ModelVarType.FIXED_SMALL, noise=z_enc)


def cmd_img2img(args) -> int:
    """Image-to-image (sd/scripts/img2img.py): the init image resized
    (LANCZOS), encoded, noised to --strength of the schedule and denoised
    by guided DDIM."""
    import torch
    from PIL import Image

    from ..samplers import cfg_eps_fn
    from ..schedules import build_sd_tables, make_ddim_timesteps
    from ..search import sd_decode_to_uint8

    dev = resolve_device(args.device)
    unet, vae, clip, tok = _sd_stack(args, dev)
    img = Image.open(args.init_img).convert("RGB").resize(
        (args.W, args.H), Image.LANCZOS)
    x = torch.from_numpy(np.array(img, np.float32) / 127.5 - 1.0) \
        .permute(2, 0, 1)[None].to(dev)
    n = args.n_samples
    steps = (ast.literal_eval(args.timesteps) if args.timesteps
             else make_ddim_timesteps("uniform", args.steps, 1000))
    tables = build_sd_tables(steps).to(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    with torch.no_grad():
        ctx = _encode_prompts(clip, tok, [args.prompt] * n, dev)
        uc = _encode_prompts(clip, tok, [""], dev)[0]
        z = img2img_latents(cfg_eps_fn(unet, ctx, uc, args.scale), vae, x,
                            tables, args.strength, n, generator=gen)
        imgs = sd_decode_to_uint8(vae.decode, z).cpu().numpy()
    logger.log(f"created {n} samples ({time.time() - t0:.3f} s)")
    out = args.out or "img2img_samples.npz"
    np.savez(out, arr_0=imgs)
    if args.save_png_dir:
        _write_pngs(args.save_png_dir, imgs)
    print(f"saved {n} samples to {out}")
    return 0


def _first_stage_defaults():
    # the first-stage flags ldm-sample and inpaint share (VQ-f4, the
    # celebahq / inpainting_big configs)
    return dict(latent_channels=3, first_stage="vq", fs_ch=128,
                fs_ch_mult="1,2,4", fs_num_res_blocks=2, fs_attn_ds="",
                n_embed=8192, embed_dim=3)


def _ldm_sample_defaults():
    # the JAX CLI's ldm-sample flags (autodiffusion_tpu/cli/main.py:
    # 1268-1280): CompVis celebahq-ldm-vq-4
    return dict(
        ckpt="", latent_size=64, **_first_stage_defaults(),
        num_channels=224, num_res_blocks=2, channel_mult="1,2,3,4",
        attention_ds="8,4,2", num_head_channels=32,
        num_classes=0, class_label=-1, context_dim=512,
        linear_start=0.0015, linear_end=0.0195, steps=50, timesteps="",
        eta=1.0, scale_factor=1.0, n_samples=4, seed=0, out="",
        save_png_dir="", use_bf16=True, device="cuda",
    )


def _ints(flag) -> tuple:
    return tuple(int(v) for v in str(flag).split(",") if v)


def _ldm_unet(args, sd, dev, in_channels: int, num_classes: int = 0,
              context_dim: int = 512):
    """The LDM UNet of the command's flags with ``model.diffusion_model.*``
    of the checkpoint ``sd`` (``context_dim`` the class token's width, for
    a class-conditional UNet)."""
    from ..models import create_ldm_unet
    from ..models.sd_convert import strip_prefix

    unet = create_ldm_unet(
        in_channels=in_channels, latent_channels=args.latent_channels,
        num_channels=args.num_channels, num_res_blocks=args.num_res_blocks,
        channel_mult=_ints(args.channel_mult),
        attention_ds=_ints(args.attention_ds),
        num_head_channels=args.num_head_channels, num_classes=num_classes,
        context_dim=context_dim, use_bf16=args.use_bf16,
        device=dev).requires_grad_(False)
    unet.load_state_dict(strip_prefix(sd, "model.diffusion_model."),
                         strict=True)
    return unet


def _ldm_first_stage(args, sd, dev):
    """The first stage (VQ or KL) of the --fs_* flags with
    ``first_stage_model.*`` of the checkpoint ``sd`` (cli/main.py:
    672-694 of the JAX package)."""
    from ..models import create_ldm_first_stage
    from ..models.sd_convert import strip_prefix

    fs = create_ldm_first_stage(
        args.first_stage, ch=args.fs_ch, ch_mult=_ints(args.fs_ch_mult),
        num_res_blocks=args.fs_num_res_blocks,
        attn_at_ds=_ints(args.fs_attn_ds),
        latent_channels=args.latent_channels, embed_dim=args.embed_dim,
        n_embed=args.n_embed, use_bf16=args.use_bf16,
        device=dev).requires_grad_(False)
    fs.load_state_dict(strip_prefix(sd, "first_stage_model."), strict=True)
    return fs


def cmd_ldm_sample(args) -> int:
    """Latent-diffusion sampling (sd/scripts/sample_diffusion.py): DDIM
    with --eta (and CompVis's noise at the last step where eta > 0) in the
    latent space, then the first stage's decode of z / --scale_factor.
    With --num_classes the cross-attention UNet is conditioned on a
    ClassEmbedder token of --class_label, or of labels drawn uniformly.
    The defaults are celebahq-ldm-vq-4's."""
    import torch

    from ..models import ClassEmbedder, load_sd_checkpoint
    from ..models.sd_convert import strip_prefix
    from ..samplers import ModelVarType, ddim_sample_loop
    from ..schedules import build_sd_tables, make_ddim_timesteps
    from ..search import to_uint8

    dev = resolve_device(args.device)
    sd = load_sd_checkpoint(args.ckpt)
    unet = _ldm_unet(args, sd, dev, args.latent_channels, args.num_classes,
                     args.context_dim)
    fs = _ldm_first_stage(args, sd, dev)
    steps = (ast.literal_eval(args.timesteps) if args.timesteps
             else make_ddim_timesteps("uniform", args.steps, 1000))
    tables = build_sd_tables(steps, linear_start=args.linear_start,
                             linear_end=args.linear_end).to(dev)
    n, hw = args.n_samples, args.latent_size
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.num_classes:
        emb = strip_prefix(sd, "cond_stage_model.")
        # the checkpoint's table as it is (cin256-v2 keeps a 1001st,
        # unconditional row); labels come from [0, num_classes)
        embedder = ClassEmbedder(
            args.context_dim, emb["embedding.weight"].shape[0]).to(dev)
        embedder.load_state_dict(emb, strict=True)
        y = (torch.full((n,), args.class_label, device=dev)
             if args.class_label >= 0 else
             torch.randint(0, args.num_classes, (n,), generator=gen,
                           device=dev))
        with torch.no_grad():
            ctx = embedder(y)

        def model_fn(x, t, i):
            return unet(x, t, ctx)
    else:
        def model_fn(x, t, i):
            return unet(x, t)
    t0 = time.time()
    with torch.no_grad():
        z = ddim_sample_loop(model_fn, (n, args.latent_channels, hw, hw),
                             tables, device=dev, generator=gen,
                             eta=args.eta, clip_denoised=False,
                             var_type=ModelVarType.FIXED_SMALL,
                             final_step_noise=args.eta > 0)
        imgs = to_uint8(fs.decode(z / args.scale_factor)).cpu().numpy()
    logger.log(f"created {n} samples ({time.time() - t0:.3f} s)")
    out = args.out or "ldm_samples.npz"
    np.savez(out, arr_0=imgs)
    if args.save_png_dir:
        _write_pngs(args.save_png_dir, imgs)
    print(f"saved {n} samples to {out}")
    return 0


def _inpaint_defaults():
    # the JAX CLI's inpaint flags (autodiffusion_tpu/cli/main.py:
    # 1282-1292): CompVis inpainting_big
    return dict(
        ckpt="", indir="", image="", mask="", outdir="inpaint_out",
        **_first_stage_defaults(),
        num_channels=256, num_res_blocks=2, channel_mult="1,2,3,4",
        attention_ds="8,4,2", num_head_channels=32,
        linear_start=0.0015, linear_end=0.0205, steps=50, seed=0,
        use_bf16=True, device="cuda",
    )


def inpaint_condition(fs, img01: np.ndarray, mask01: np.ndarray, device):
    """make_batch's conditioning (inpaint.py:11-30): the masked image
    (1 - mask) x image, mapped to [-1, 1] and encoded (a KL first stage's
    mean), beside the binary mask mapped to [-1, 1] and resized to the
    latent grid the encoder produced (its stride-2 convs round odd sizes
    up). The resize samples at half-pixel centres, as the JAX package's
    ``jax.image.resize(..., "nearest")``: 16 -> 4 picks rows 2, 6, 10,
    14 (``nearest-exact``; CompVis's inpaint.py takes torch's ``nearest``,
    rows 0, 4, 8, 12). img01 [H, W, 3] and mask01 [H, W] float32 in
    [0, 1]; returns [1, C + 1, h, w]."""
    import torch
    import torch.nn.functional as F

    masked = (1.0 - mask01)[..., None] * img01
    x = torch.from_numpy(masked * 2.0 - 1.0).permute(2, 0, 1)[None]
    c = fs.encode(x.to(device))
    if isinstance(c, tuple):                   # KL: (mean, logvar)
        c = c[0]
    cc = F.interpolate(torch.from_numpy(mask01 * 2.0 - 1.0)[None, None],
                       size=tuple(c.shape[2:]), mode="nearest-exact")
    return torch.cat([c.float(), cc.to(device)], dim=1)


def inpaint_composite(pred: np.ndarray, img01: np.ndarray,
                      mask01: np.ndarray) -> np.ndarray:
    """The decoded prediction pred [3, h, w] in [-1, 1], mapped to [0, 1],
    cropped to the image (a decode of a rounded-up grid overshoots) and
    composited with the image outside the mask; uint8 [H, W, 3]."""
    h, w = img01.shape[:2]
    pred01 = np.clip((pred.transpose(1, 2, 0) + 1.0) / 2.0, 0, 1)[:h, :w]
    out01 = (1.0 - mask01)[..., None] * img01 + mask01[..., None] * pred01
    return (out01 * 255.0 + 0.5).astype(np.uint8)


def cmd_inpaint(args) -> int:
    """Latent inpainting (sd/scripts/inpaint.py, an inpainting_big-style
    model): the UNet takes [x, the masked image's latent, the mask] on its
    channels; the sampled latent is decoded and composited with the image
    outside the mask. --indir scans for ``X.png`` + ``X_mask.png`` pairs,
    --image / --mask name one pair."""
    import glob
    import torch
    from PIL import Image

    from ..models import load_sd_checkpoint
    from ..samplers import ModelVarType, ddim_sample_loop
    from ..schedules import build_sd_tables, make_ddim_timesteps

    dev = resolve_device(args.device)
    pairs = ([(args.image, args.mask)] if args.image else
             [(m.replace("_mask.png", ".png"), m) for m in
              sorted(glob.glob(os.path.join(args.indir, "*_mask.png")))])
    if not pairs:
        print("no image/mask pairs found")
        return 1
    sd = load_sd_checkpoint(args.ckpt)
    unet = _ldm_unet(args, sd, dev, 2 * args.latent_channels + 1)
    fs = _ldm_first_stage(args, sd, dev)
    tables = build_sd_tables(make_ddim_timesteps("uniform", args.steps, 1000),
                             linear_start=args.linear_start,
                             linear_end=args.linear_end).to(dev)
    os.makedirs(args.outdir, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    for n_done, (img_path, mask_path) in enumerate(pairs, 1):
        img01 = np.asarray(Image.open(img_path).convert("RGB"),
                           np.float32) / 255.0
        mask01 = (np.asarray(Image.open(mask_path).convert("L"),
                             np.float32) / 255.0 >= 0.5).astype(np.float32)
        with torch.no_grad():
            cond = inpaint_condition(fs, img01, mask01, dev)

            def model_fn(x, t, i, cond=cond):
                return unet(torch.cat(
                    [x, cond.expand(x.shape[0], -1, -1, -1)], dim=1), t)

            z = ddim_sample_loop(
                model_fn, (1, args.latent_channels) + tuple(cond.shape[2:]),
                tables, device=dev, generator=gen, clip_denoised=False,
                var_type=ModelVarType.FIXED_SMALL)
            pred = fs.decode(z)[0].float().cpu().numpy()
        out_path = os.path.join(args.outdir, os.path.basename(img_path))
        Image.fromarray(inpaint_composite(pred, img01, mask01)).save(out_path)
        print(f"inpainted {img_path} -> {out_path}")
        logger.log(f"created {n_done} samples ({time.time() - t0:.3f} s)")
    return 0


def cmd_selftest(args) -> int:
    """The FID pipeline's checks against a pytorch_fid Inception ``.pth``
    (fid/selftest.py): one JSON line; exit 0 iff every consistency check
    passed ("certified" also needs the genuine file's digest)."""
    from ..fid.selftest import run_selftest

    out = run_selftest(
        args.inception_path, ref_batch=args.ref_batch or None,
        ref_stats=args.ref_stats or None,
        expected_fid=None if args.expected_fid < 0 else args.expected_fid,
        tol=args.tol, batch_size=args.batch_size, n_fixture=args.n_fixture,
        seed=args.seed, device=resolve_device(args.device))
    print(json.dumps(out))
    return 0 if out["passed"] else 1


def cmd_convert(args) -> int:
    """A torch checkpoint -> the JAX package's msgpack params (``adt
    convert``'s files, byte for byte): --preset sd a CompVis SD .ckpt ->
    the params directory of the three towers (sd_unet / sd_vae /
    sd_clip.msgpack, which every SD command reads with --ckpt <dir>),
    --preset adm64 or default a guided-diffusion UNet .pt -> one param
    tree (ModelConfig.adm64() or ModelConfig()). The weights are loaded
    into the port's models on --device (strictly: every name, every
    shape) and written from there."""
    from ..models import (ModelConfig, create_model, create_sd_models,
                          load_sd_checkpoint, save_sd_params_dir,
                          split_sd_checkpoint)
    from ..models.convert import flax_tree_from_unet
    from ..utils.checkpoint import load_checkpoint, save_msgpack

    dev = resolve_device(args.device)
    if args.preset == "sd":
        parts = split_sd_checkpoint(load_sd_checkpoint(args.torch_path))
        towers = create_sd_models(False, device=dev)
        for module, part in zip(towers, parts):
            module.load_state_dict(part, strict=True)
        save_sd_params_dir(args.out, *towers)
        print(f"converted {args.torch_path} -> {args.out}/"
              f"{{sd_unet,sd_vae,sd_clip}}.msgpack")
        return 0
    sd = load_checkpoint(args.torch_path)
    cfg = ModelConfig.adm64() if args.preset == "adm64" else ModelConfig()
    model = create_model(cfg, device=dev)
    model.load_state_dict(sd.get("state_dict", sd), strict=True)
    save_msgpack(args.out, flax_tree_from_unet(model))
    print(f"converted {args.torch_path} -> {args.out}")
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
    p = sub.add_parser("sr-sample", help="super-resolution sampling")
    add_dict_to_argparser(p, _sr_sample_defaults())
    p.set_defaults(fn=cmd_sr_sample)
    p = sub.add_parser("search-sd", help="Stable Diffusion latent search")
    add_dict_to_argparser(p, _search_sd_defaults())
    p.set_defaults(fn=cmd_search_sd)
    p = sub.add_parser("train", help="train/fine-tune a diffusion UNet")
    add_dict_to_argparser(p, _train_defaults())
    p.set_defaults(fn=cmd_train)
    p = sub.add_parser("train-classifier",
                       help="train the noisy guidance classifier")
    add_dict_to_argparser(p, _train_classifier_defaults())
    p.set_defaults(fn=cmd_train_classifier)
    p = sub.add_parser("nll", help="bits/dim over a dataset")
    add_dict_to_argparser(p, _nll_defaults())
    p.set_defaults(fn=cmd_nll)
    p = sub.add_parser("txt2img", help="text-to-image sampling (SD)")
    add_dict_to_argparser(p, _txt2img_defaults())
    p.set_defaults(fn=cmd_txt2img)
    p = sub.add_parser("img2img", help="image-to-image (SD)")
    add_dict_to_argparser(p, _img2img_defaults())
    p.set_defaults(fn=cmd_img2img)
    p = sub.add_parser("ldm-sample",
                       help="unconditional latent-diffusion sampling")
    add_dict_to_argparser(p, _ldm_sample_defaults())
    p.set_defaults(fn=cmd_ldm_sample)
    p = sub.add_parser("inpaint",
                       help="latent inpainting over image+mask pairs")
    add_dict_to_argparser(p, _inpaint_defaults())
    p.set_defaults(fn=cmd_inpaint)
    p = sub.add_parser("convert", help="torch checkpoint -> msgpack")
    add_dict_to_argparser(p, dict(torch_path="", out="", preset="adm64",
                                  device="cuda"))
    p.set_defaults(fn=cmd_convert)
    p = sub.add_parser(
        "selftest",
        help="certify the FID pipeline against real pt_inception weights")
    add_dict_to_argparser(p, dict(inception_path="", ref_batch="",
                                  ref_stats="", expected_fid=-1.0, tol=0.5,
                                  batch_size=32, n_fixture=32, seed=0,
                                  device="cuda"))
    p.set_defaults(fn=cmd_selftest)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 \
            and args.cmd not in DATA_PARALLEL:
        raise ValueError(f"adt-torch {args.cmd} runs one process; of the "
                         f"commands only {', '.join(DATA_PARALLEL)} run "
                         "under torchrun with more than one")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
