from hirest_tpu_torch.serve.engine import ServingEngine  # noqa: F401
from hirest_tpu_torch.serve.server import make_server  # noqa: F401
