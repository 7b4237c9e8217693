"""Fresh-seed re-evaluation of the method-level proof with the PyTorch port.

The recipe of eval_schedules.py through ``autodiffusion_tpu_torch``: the
searched K = 4 schedule against the uniform DDIM-4 seed on the trained
model (an EMA ``.pt`` from ``adt-torch train``), both folded into one
chunk of the search-time fitness per repeat, ``--repeats`` times with
fresh sampling noise; then the deployment path once, ``adt-torch sample
--use_timestep <searched>`` and ``adt-torch evaluate`` against the same
reference statistics. Writes ``proof_torch.json`` in the workspace.

    python eval_schedules_torch.py --workspace WS --ema WS/train/ema_...pt
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    ".."))
sys.path.insert(0, REPO)


def _adt_torch(*argv, **kw):
    return subprocess.run(
        [sys.executable, "-m", "autodiffusion_tpu_torch.cli.main", *argv],
        check=True, env=dict(os.environ, PYTHONPATH=REPO + ":"
                             + os.environ.get("PYTHONPATH", "")), **kw)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--ema", required=True)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--num_samples", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    ws = args.workspace
    with open(os.path.join(ws, "search_result.json")) as f:
        res = json.loads(f.read().strip().splitlines()[-1])
    searched = tuple(sorted(res["best"]))

    import torch

    from autodiffusion_tpu_torch.fid import (FIDStats, inception_apply,
                                             load_fid_inception)
    from autodiffusion_tpu_torch.models import ModelConfig, create_model
    from autodiffusion_tpu_torch.schedules import space_timesteps
    from autodiffusion_tpu_torch.search import make_adm_fitness

    # run_proof_torch.sh's MODEL_FLAGS and the CLI defaults for the rest
    cfg = ModelConfig(image_size=32, num_channels=64, num_res_blocks=2,
                      attention_resolutions="16,8", class_cond=False,
                      learn_sigma=True, noise_schedule="cosine",
                      use_scale_shift_norm=True, resblock_updown=True,
                      use_new_attention_order=True, num_head_channels=64,
                      use_bf16=True)
    model = create_model(cfg, device=args.device).requires_grad_(False)
    model.load_state_dict(torch.load(args.ema, map_location="cpu",
                                     weights_only=True))
    inception = load_fid_inception(os.path.join(ws, "pt_inception.pth"),
                                   device=args.device)
    fitness = make_adm_fitness(
        model=model, image_size=32,
        feature_fn=lambda imgs: inception_apply(inception, imgs),
        ref_stats=FIDStats.load(os.path.join(ws, "ref_stats.npz")),
        num_samples=args.num_samples, batch_size=args.batch_size,
        base_schedule="cosine", num_classes=None, use_ddim=True,
        learn_sigma=True, candidate_chunk=2, seed=20260819,
        device=args.device)
    uniform = tuple(sorted(space_timesteps(1000, f"ddim{len(searched)}")))
    rows = {"uniform": [], "searched": []}
    for r in range(args.repeats):
        u, s = fitness([uniform, searched])
        rows["uniform"].append(float(u))
        rows["searched"].append(float(s))
        print(f"repeat {r}: uniform={u:.4f} searched={s:.4f}", flush=True)
    mu_u, mu_s = (statistics.mean(rows[k]) for k in ("uniform", "searched"))
    sd_u, sd_s = (statistics.stdev(rows[k]) if args.repeats > 1 else 0.0
                  for k in ("uniform", "searched"))
    noise = max(sd_u, sd_s)
    out = {"uniform_ddim4": uniform, "searched": searched,
           "search_time_fid": res["fid"], "num_samples": args.num_samples,
           "repeats": args.repeats, "uniform_fids": rows["uniform"],
           "searched_fids": rows["searched"], "uniform_mean": mu_u,
           "uniform_std": sd_u, "searched_mean": mu_s, "searched_std": sd_s,
           "improvement": mu_u - mu_s,
           "separation_sigma": (mu_u - mu_s) / noise if noise > 0
           else float("inf"),
           "beats_noise": bool(mu_s + 2 * noise < mu_u - 2 * noise)}

    npz = os.path.join(ws, "deploy_samples.npz")
    _adt_torch("sample", "--device", args.device, "--model_path", args.ema,
               "--use_timestep", str(list(searched)),
               "--num_samples", str(args.num_samples),
               "--batch_size", str(args.batch_size), "--seed", "31337",
               "--out", npz, "--image_size", "32", "--num_channels", "64",
               "--num_res_blocks", "2", "--attention_resolutions", "16,8",
               "--class_cond", "False", "--learn_sigma", "True",
               "--noise_schedule", "cosine")
    ev = _adt_torch("evaluate", "--device", args.device, "--sample_batch",
                    npz, "--ref_stats", os.path.join(ws, "ref_stats.npz"),
                    "--inception_path", os.path.join(ws, "pt_inception.pth"),
                    "--batch_size", "100", capture_output=True, text=True)
    deploy = json.loads(ev.stdout.strip().splitlines()[-1])["fid"]
    out["deploy_fid"] = deploy
    out["deploy_within_noise"] = bool(abs(deploy - mu_s)
                                      <= max(4 * noise, 0.05 * mu_s))
    with open(os.path.join(ws, "proof_torch.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
