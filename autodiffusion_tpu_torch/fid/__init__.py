"""FID: InceptionV3 pool3 features, streamed moments, Frechet distance,
Inception Score, precision / recall and the offline evaluator."""

from .evaluator import FIDEvaluator, inception_apply, make_inception_feature_fn
from .inception import (FIDInceptionV3, fold_pt_inception, load_fid_inception,
                        preprocess, synthesize_pt_inception)
from .prd import manifold_radii, pairwise_sq_distances, precision_recall
from .stats import (FeatureStats, FIDStats, accumulate_stats, finalize_stats,
                    frechet_distance, frechet_distance_eigh, inception_score,
                    make_device_frechet)

__all__ = ["FIDEvaluator", "inception_apply", "make_inception_feature_fn",
           "FIDInceptionV3", "fold_pt_inception", "load_fid_inception",
           "preprocess", "synthesize_pt_inception", "manifold_radii",
           "pairwise_sq_distances", "precision_recall", "FeatureStats",
           "FIDStats", "accumulate_stats", "finalize_stats",
           "frechet_distance", "frechet_distance_eigh", "inception_score",
           "make_device_frechet"]
