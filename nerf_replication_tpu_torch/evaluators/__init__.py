"""Evaluator factory: ``cfg.evaluator_module`` resolves through the port's
registry."""

from ..registry import resolve
from . import img_fit, nerf  # noqa: F401 (registry side effects)
from .metrics import psnr, psnr_uint8, ssim


def make_evaluator(cfg):
    return resolve("evaluator", cfg.evaluator_module)(cfg)


__all__ = ["make_evaluator", "psnr", "psnr_uint8", "ssim"]
