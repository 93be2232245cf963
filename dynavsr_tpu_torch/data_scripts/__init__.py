"""Data preparation (port of the repo's data_scripts/): clip-folder trees
into LMDBs, mod-cropped GT and bicubic or DUF LR trees. Run as
`python -m dynavsr_tpu_torch.data_scripts.<name>`."""
