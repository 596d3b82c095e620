from skred_tpu_torch.assets.bank import WaveBank, PackedBank  # noqa: F401
