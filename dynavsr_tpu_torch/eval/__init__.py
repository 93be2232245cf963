"""Metrics, image conversion, clip scoring, tiled inference and streaming."""
from dynavsr_tpu_torch.eval.convert_img import tensor2img
from dynavsr_tpu_torch.eval.metrics import calculate_psnr, calculate_ssim
