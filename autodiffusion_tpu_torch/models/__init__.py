"""The diffusion models of the port (NCHW, the reference checkpoints' own
module names): the ADM UNet and noisy classifier (guided-diffusion), and
Stable Diffusion's UNet, AutoencoderKL and CLIP text encoder (CompVis and
HF names)."""

from .clip_text import CLIPTextConfig, CLIPTextEncoder, ClipBPETokenizer
from .factory import (SD_V1_UNET, SD_V1_VAE, ClassifierConfig, ModelConfig,
                      create_classifier, create_model, create_sd_models,
                      create_tables, random_init_)
from .sd_convert import load_sd_checkpoint, split_sd_checkpoint
from .sd_unet import SDUNetModel
from .unet import EncoderUNetModel, UNetModel, unet_layer_count
from .vae import SD_SCALE_FACTOR, AutoencoderKL

__all__ = ["ClassifierConfig", "ModelConfig", "create_classifier",
           "create_model", "create_tables", "random_init_",
           "EncoderUNetModel", "UNetModel", "unet_layer_count",
           "CLIPTextConfig", "CLIPTextEncoder", "ClipBPETokenizer",
           "SD_V1_UNET", "SD_V1_VAE", "create_sd_models",
           "load_sd_checkpoint", "split_sd_checkpoint", "SDUNetModel",
           "SD_SCALE_FACTOR", "AutoencoderKL"]
