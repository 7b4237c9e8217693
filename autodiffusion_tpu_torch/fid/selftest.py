"""The FID pipeline's self-test against a pytorch_fid Inception checkpoint
(``adt-torch selftest``).

Port of autodiffusion_tpu/fid/selftest.py. Every FID stage of the port is
held to independent implementations with random weights, because the
genuine pt_inception-2015-12-05-6726825d.pth is not bundled
(evaluator_v1.py:652-679 downloads it). This module makes the remaining
step one command wherever the real file is at hand:

    adt-torch selftest --inception_path pt_inception-2015-12-05-6726825d.pth \
        [--ref_batch VIRTUAL_imagenet64_labeled.npz] \
        [--ref_stats published_stats.npz --expected_fid F] [--device cpu]

The checks (each reported in one JSON line):
  1. the sha256 of the weights file: the genuine checkpoint's digest
     starts with 6726825d (the suffix torchvision's check_hash verifies);
  2. strict loads of the file into the port's BN-folded FIDInceptionV3
     and into the independent torch mirror (fid/torch_mirror.py), which
     keeps the checkpoint's batch norms as modules;
  3. pool3, spatial and logits of the port's network (its own
     preprocessing, on ``device``) against the mirror's (float32 on the
     CPU) on seeded uint8 images at 299 (native) and 64 (the resize path),
     each within 1e-3 of the mirror's scale;
  4. FID through the port's pipeline (FIDEvaluator: features, moments,
     Frechet) against a pytorch_fid-style computation (the mirror's
     features, float64 ``np.cov`` and ``scipy.linalg.sqrtm``) on a
     two-batch fixture, within 2 % relative;
  5. optionally the FID of --ref_batch against --ref_stats, compared with
     --expected_fid when given.

``passed``: every consistency check held. ``certified``: passed, and the
weights are the genuine checkpoint's, so a synthesized checkpoint gives
passed = true and certified = false.
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import no_tf32, resolve_device

__all__ = ["GENUINE_SHA256_PREFIX", "run_selftest"]

# pt_inception-2015-12-05-6726825d.pth: the 8-hex-digit name suffix is the
# sha256 prefix torchvision verifies on download (pytorch_fid FID_WEIGHTS_URL)
GENUINE_SHA256_PREFIX = "6726825d"


@contextlib.contextmanager
def _no_cudnn_tf32():
    """Float32 convolutions in full float32 for the block (cuDNN takes TF32
    by default), as the mirror's CPU convolutions are."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _reference_fid(fa: np.ndarray, fb: np.ndarray) -> float:
    """pytorch_fid's calculate_frechet_distance on float64 features:
    np.cov moments and scipy's sqrtm (an eps offset where the product is
    singular, the real part kept)."""
    from scipy import linalg

    def sqrtm(a):
        out = linalg.sqrtm(a)
        return out[0] if isinstance(out, tuple) else out  # scipy < 1.18

    mu1, mu2 = fb.mean(0), fa.mean(0)
    s1, s2 = np.cov(fb, rowvar=False), np.cov(fa, rowvar=False)
    covmean = sqrtm(s1.dot(s2))
    if not np.isfinite(covmean).all():
        off = np.eye(s1.shape[0]) * 1e-6
        covmean = sqrtm((s1 + off).dot(s2 + off))
    covmean = covmean.real
    diff = mu1 - mu2
    return float(diff.dot(diff) + np.trace(s1) + np.trace(s2)
                 - 2 * np.trace(covmean))


def _first_images(path: str) -> np.ndarray:
    """The images of a reference batch: arr_0 (OpenAI's reference batches
    hold a label array beside it), else the first [N, H, W, 3] entry."""
    with np.load(path) as z:
        if "arr_0" in z.files:
            return z["arr_0"]
        keys = [k for k in z.files if z[k].ndim == 4 and z[k].shape[-1] == 3]
        if not keys:
            raise ValueError(f"{path} has no [N, H, W, 3] image array "
                             f"(keys: {z.files})")
        return z[keys[0]]


def run_selftest(inception_path: str, *, ref_batch: Optional[str] = None,
                 ref_stats: Optional[str] = None,
                 expected_fid: Optional[float] = None, tol: float = 0.5,
                 batch_size: int = 32, n_fixture: int = 32, seed: int = 0,
                 device=None) -> Dict[str, Any]:
    """The five checks above; the port's network on ``device`` (cuda by
    default), float32 with TF32 off. Returns {"checks": {...}, "passed",
    "certified"[, "note"]}."""
    from .evaluator import FIDEvaluator, make_inception_feature_fn
    from .inception import load_fid_inception
    from .stats import FIDStats
    from .torch_mirror import build_torch_mirror, load_mirror_state

    # inconsistent arguments fail before the minutes of work below
    if bool(ref_batch) != bool(ref_stats):
        raise ValueError("--ref_batch and --ref_stats must be given together "
                         "(the reference-batch FID scores one against the "
                         "other)")
    dev = resolve_device(device)
    out: Dict[str, Any] = {"checks": {}}
    checks = out["checks"]

    # 1. the weights' digest
    h = hashlib.sha256()
    with open(inception_path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    digest = h.hexdigest()
    genuine = digest.startswith(GENUINE_SHA256_PREFIX)
    checks["weights_sha256"] = {"value": digest, "genuine": genuine}

    # 2. strict loads (each raises on a missing or unexpected key)
    model = load_fid_inception(inception_path, device=dev)
    checks["port_load"] = {"ok": True}
    mirror = load_mirror_state(build_torch_mirror(), inception_path)
    checks["torch_mirror_load"] = {"ok": True}
    feature_fn = make_inception_feature_fn(model)

    def ours(imgs_u8):
        with no_tf32(), _no_cudnn_tf32():
            return {k: v.float().cpu().numpy()
                    for k, v in feature_fn(imgs_u8).items()}

    def theirs(imgs_u8):
        tx = torch.from_numpy(
            imgs_u8.transpose(0, 3, 1, 2).astype(np.float32)) / 255.0
        if imgs_u8.shape[1] != 299:
            tx = F.interpolate(tx, size=(299, 299), mode="bilinear",
                               align_corners=False)
        with torch.no_grad():
            return {k: v.numpy() for k, v in mirror(tx * 2.0 - 1.0).items()}

    # 3. features on seeded fixtures, native size and the resize path
    rng = np.random.RandomState(seed)
    for size in (299, 64):
        imgs = rng.randint(0, 256, (4, size, size, 3), dtype=np.uint8)
        a, b = ours(imgs), theirs(imgs)
        rep = {f"{k}_rel": _rel_err(a[k], b[k])
               for k in ("pool3", "logits", "spatial")}
        rep["ok"] = all(v < 1e-3 for v in rep.values())
        checks[f"feature_parity_{size}"] = rep

    # 4. FID through the port's pipeline against pytorch_fid's arithmetic
    a = rng.randint(0, 256, (n_fixture, 64, 64, 3), dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + rng.randint(-40, 40, a.shape),
                0, 255).astype(np.uint8)
    with no_tf32(), _no_cudnn_tf32():
        ev = FIDEvaluator(feature_fn, None, batch_size=batch_size)
        sa = FIDStats.from_features(
            ev.compute_activations(a)[0].cpu().numpy())
        ours_fid = FIDEvaluator(feature_fn, sa,
                                batch_size=batch_size).cal_fid(b)
    ref_fid = _reference_fid(theirs(a)["pool3"].astype(np.float64),
                             theirs(b)["pool3"].astype(np.float64))
    rep = {"ours": float(ours_fid), "pytorch_fid_style": ref_fid}
    # n_fixture << 2048 leaves both covariances rank-deficient, and sqrtm
    # amplifies the features' < 1e-3 relative differences: a relative bound
    rep["ok"] = abs(rep["ours"] - ref_fid) <= 0.02 * max(1.0, abs(ref_fid))
    checks["fid_reproduction"] = rep

    # 5. the published artifacts (both or neither, checked on entry)
    if ref_batch:
        with no_tf32(), _no_cudnn_tf32():
            fid = FIDEvaluator(feature_fn, FIDStats.load(ref_stats),
                               batch_size=batch_size).cal_fid(
                                   _first_images(ref_batch))
        rep = {"fid": float(fid)}
        if expected_fid is not None:
            rep["expected"] = float(expected_fid)
            rep["ok"] = abs(fid - expected_fid) <= tol
        checks["ref_batch_fid"] = rep

    hard = [c["ok"] for c in checks.values() if isinstance(c.get("ok"), bool)]
    out["passed"] = bool(hard) and all(hard)
    out["certified"] = out["passed"] and genuine
    if not genuine:
        out["note"] = ("weights are NOT the genuine pt_inception-2015-12-05 "
                       "checkpoint (sha256 mismatch); the consistency checks "
                       "ran, certification needs the real file")
    return out
