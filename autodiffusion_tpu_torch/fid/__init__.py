"""FID: InceptionV3 pool3 features, streamed moments, Frechet distance."""

from .evaluator import inception_apply
from .inception import (FIDInceptionV3, fold_pt_inception, load_fid_inception,
                        preprocess, synthesize_pt_inception)
from .stats import (FeatureStats, FIDStats, accumulate_stats, finalize_stats,
                    frechet_distance_eigh, make_device_frechet)

__all__ = ["inception_apply", "FIDInceptionV3", "fold_pt_inception",
           "load_fid_inception", "preprocess", "synthesize_pt_inception",
           "FeatureStats", "FIDStats", "accumulate_stats", "finalize_stats",
           "frechet_distance_eigh", "make_device_frechet"]
