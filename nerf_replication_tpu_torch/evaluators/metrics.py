"""Image metrics: uint8-quantized and float PSNR and SSIM, as
nerf_replication_tpu/evaluators/metrics.py (numpy + scipy): PSNR on images
quantized by truncation to uint8 then taken as floats; float PSNR in
float64 (skimage's ``peak_signal_noise_ratio``); SSIM matching
``skimage.metrics.structural_similarity`` defaults (uniform 7x7 window,
K1 0.01, K2 0.03, unbiased covariance, valid-region mean)."""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def psnr_uint8(img_pred: np.ndarray, img_gt: np.ndarray) -> float:
    p = (np.clip(img_pred, 0, 1) * 255).astype(np.uint8).astype(np.float64)
    g = (np.clip(img_gt, 0, 1) * 255).astype(np.uint8).astype(np.float64)
    mse = np.mean((p - g) ** 2)
    if mse < 1e-10:
        return 100.0
    return float(10.0 * np.log10(255.0 ** 2 / mse))


def psnr(img_pred: np.ndarray, img_gt: np.ndarray,
         data_range: float = 1.0) -> float:
    """Float PSNR, the MSE taken in float64; 100 dB below an MSE of
    1e-12."""
    mse = np.mean((np.asarray(img_pred, np.float64)
                   - np.asarray(img_gt, np.float64)) ** 2)
    if mse < 1e-12:
        return 100.0
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _ssim_single(x: np.ndarray, y: np.ndarray, win_size: int,
                 data_range: float) -> float:
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    n = win_size ** 2
    cov_norm = n / (n - 1.0)

    def filt(im):
        return uniform_filter(im, size=win_size)

    ux, uy = filt(x), filt(y)
    vx = cov_norm * (filt(x * x) - ux * ux)
    vy = cov_norm * (filt(y * y) - uy * uy)
    vxy = cov_norm * (filt(x * y) - ux * uy)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)
         / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)))
    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean() if pad > 0 else s.mean())


def ssim(img_pred: np.ndarray, img_gt: np.ndarray, win_size: int = 7,
         data_range: float | None = None,
         channel_axis: int | None = None) -> float:
    """Mean SSIM; uint8 inputs default to data_range 255, floats to 1."""
    img_pred, img_gt = np.asarray(img_pred), np.asarray(img_gt)
    if data_range is None:
        data_range = 255.0 if img_pred.dtype == np.uint8 else 1.0
    if channel_axis is None:
        return _ssim_single(img_pred, img_gt, win_size, data_range)
    return float(np.mean([
        _ssim_single(np.take(img_pred, c, axis=channel_axis),
                     np.take(img_gt, c, axis=channel_axis), win_size,
                     data_range)
        for c in range(img_pred.shape[channel_axis])]))
