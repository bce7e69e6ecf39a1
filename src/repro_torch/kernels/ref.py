"""Plain PyTorch versions of every kernel, under the reference's names (the
allclose ground truth).  Each lives beside its kernel; this module only
re-exports them."""
from repro_torch.kernels.decode_attention import (  # noqa: F401
    decode_attention_plain as decode_attention_ref,
)
from repro_torch.kernels.flash_attention import (  # noqa: F401
    NEG_INF, flash_attention_plain as flash_attention_ref,
)
from repro_torch.kernels.grouped_gemm import (  # noqa: F401
    grouped_gemm_plain as grouped_gemm_ref,
)
from repro_torch.kernels.wkv_chunk import (  # noqa: F401
    wkv_sequential as wkv_ref,
)
