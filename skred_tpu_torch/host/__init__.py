from skred_tpu_torch.host.engine import HostEngine  # noqa: F401
from skred_tpu_torch.host.wire import WireContext  # noqa: F401
