"""Hand-written Hopper (sm_90a) kernels for the perf-critical operators the
paper models (prefill attention, KV-cache decode attention, MoE grouped GEMM)
and the chunked RWKV6 recurrence that rwkv6's prefill runs.
ops.py holds the public wrappers; ref.py the plain PyTorch versions."""
from repro_torch.kernels import ops, ref  # noqa: F401
