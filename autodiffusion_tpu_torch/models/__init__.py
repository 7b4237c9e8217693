"""ADM UNet and noisy classifier (guided-diffusion module names, NCHW)."""

from .factory import (ClassifierConfig, ModelConfig, create_classifier,
                      create_model, create_tables, random_init_)
from .unet import EncoderUNetModel, UNetModel, unet_layer_count

__all__ = ["ClassifierConfig", "ModelConfig", "create_classifier",
           "create_model", "create_tables", "random_init_",
           "EncoderUNetModel", "UNetModel", "unet_layer_count"]
