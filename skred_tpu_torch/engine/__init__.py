from skred_tpu_torch.engine.render import render_timeline  # noqa: F401
