"""DynaVSR meta-training entry (the reference's meta-train script name;
port of dynavsr_tpu/cli/train_dynavsr.py). A thin alias: cli/train.py
dispatches on opt['model'], and the meta configs set `model: video_meta`.

    python -m dynavsr_tpu_torch.cli.train_dynavsr -opt configs/train/train_DynaVSR_EDVR_REDS.yml [--device cpu]
"""

from dynavsr_tpu_torch.cli.train import main

if __name__ == "__main__":
    main()
