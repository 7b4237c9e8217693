"""Data the search reads: the COCO captions of the Stable Diffusion search."""

from .coco import load_captions

__all__ = ["load_captions"]
