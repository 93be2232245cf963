"""MFDN / SFDN training entry (the reference's train_downscaler script
name; port of dynavsr_tpu/cli/train_downscaler.py). A thin alias:
cli/train.py dispatches on opt['model'], and the downscaler configs set
`model: downscaler`.

    python -m dynavsr_tpu_torch.cli.train_downscaler -opt configs/train/train_MFDN_Vimeo90K.yml [--device cpu]
"""

from dynavsr_tpu_torch.cli.train import main

if __name__ == "__main__":
    main()
