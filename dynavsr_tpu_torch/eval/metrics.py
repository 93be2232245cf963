"""PSNR / SSIM, bit-compatible with the reference's utils/util.py [H].

Both operate on uint8-range images (0..255) as float64, exactly like the
reference: PSNR from MSE of the rounded uint8 images; SSIM with an 11x11
Gaussian window (sigma 1.5), computed on the 'valid' interior (the reference
filters with cv2.filter2D then crops [5:-5, 5:-5], which equals a valid-mode
correlation). Parity here gates the <=0.05 dB acceptance metric.
"""

from __future__ import annotations

import numpy as np

__all__ = ["calculate_psnr", "calculate_ssim"]


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR between two images in [0, 255] (any shape, same shape)."""
    a = img1.astype(np.float64)
    b = img2.astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(255.0 / np.sqrt(mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    # Same as cv2.getGaussianKernel(size, sigma) outer itself.
    r = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(r**2) / (2.0 * sigma**2))
    g /= g.sum()
    return np.outer(g, g)


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    # Imported here: scipy.signal takes seconds to import, and a process
    # that never scores (a training rank, a spawned worker) should not wait.
    from scipy.signal import convolve2d

    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    a = img1.astype(np.float64)
    b = img2.astype(np.float64)
    win = _gaussian_window()

    mu1 = convolve2d(a, win, mode="valid")
    mu2 = convolve2d(b, win, mode="valid")
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = convolve2d(a * a, win, mode="valid") - mu1_sq
    sigma2_sq = convolve2d(b * b, win, mode="valid") - mu2_sq
    sigma12 = convolve2d(a * b, win, mode="valid") - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """SSIM; grayscale (H, W) or color (H, W, 3) averaged per channel [H]."""
    if img1.shape != img2.shape:
        raise ValueError("input images must have the same dimensions")
    if img1.ndim == 2:
        return _ssim_single(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 3:
            return float(np.mean([_ssim_single(img1[..., i], img2[..., i]) for i in range(3)]))
        if img1.shape[2] == 1:
            return _ssim_single(img1[..., 0], img2[..., 0])
    raise ValueError(f"unsupported image shape {img1.shape}")
