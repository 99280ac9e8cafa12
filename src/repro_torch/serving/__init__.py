from repro_torch.serving.engine import Request, RequestStats, ServeEngine
from repro_torch.serving.sampling import sample_host, sample_tokens

__all__ = ["Request", "RequestStats", "ServeEngine", "sample_host",
           "sample_tokens"]
