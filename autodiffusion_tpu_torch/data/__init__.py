"""Data: image folders and uint8 ``.npy`` arrays (ADM training), the COCO
captions of the Stable Diffusion search."""

from .coco import load_captions
from .images import ImageDataset, list_image_files_recursively, load_data

__all__ = ["load_captions", "ImageDataset", "list_image_files_recursively",
           "load_data"]
