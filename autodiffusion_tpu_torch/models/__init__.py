"""The diffusion models of the port (NCHW, the reference checkpoints' own
module names): the ADM UNet and noisy classifier (guided-diffusion), and
Stable Diffusion's UNet, AutoencoderKL and CLIP text encoder (CompVis and
HF names), and the latent-diffusion VQ first stage and class embedder."""

from .clip_text import (ClassEmbedder, CLIPTextConfig, CLIPTextEncoder,
                        ClipBPETokenizer)
from .factory import (SD_V1_UNET, SD_V1_VAE, ClassifierConfig, ModelConfig,
                      create_classifier, create_ldm_first_stage,
                      create_ldm_unet, create_model, create_sd_models,
                      create_sr_model,
                      create_tables, random_init_)
from .sd_convert import (load_sd_checkpoint, load_sd_params_dir,
                         load_sd_weights, save_sd_params_dir,
                         split_sd_checkpoint)
from .sd_unet import SDUNetModel
from .unet import (EncoderUNetModel, SuperResModel, UNetModel,
                   unet_layer_count)
from .vae import (SD_SCALE_FACTOR, AutoencoderKL, VectorQuantizer,
                  VQModelInterface)

__all__ = ["ClassifierConfig", "ModelConfig", "create_classifier",
           "create_model", "create_sr_model", "create_tables",
           "random_init_", "EncoderUNetModel", "SuperResModel", "UNetModel",
           "unet_layer_count",
           "CLIPTextConfig", "CLIPTextEncoder", "ClipBPETokenizer",
           "SD_V1_UNET", "SD_V1_VAE", "create_sd_models",
           "create_ldm_unet", "create_ldm_first_stage", "ClassEmbedder",
           "load_sd_checkpoint", "split_sd_checkpoint", "load_sd_params_dir",
           "save_sd_params_dir", "load_sd_weights", "SDUNetModel",
           "SD_SCALE_FACTOR", "AutoencoderKL", "VectorQuantizer",
           "VQModelInterface"]
