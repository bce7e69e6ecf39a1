"""The port's recurrent models (rwkv6 by its plain loop and by the chunked
WKV6 path, recurrentgemma's RG-LRU) and the encoder-decoder against the
reference's, with the same weights: loss and metrics, prefill logits and
teacher-forced decode at 2e-5 in f32, the port's own prefill+decode against
its full prefill at 2e-3 (``test_torch_parity``)."""
import pytest

from test_torch_parity import case_id, check_model_matches_reference

CASES = [
    ("rwkv6-1.6b", None),             # rwkv recurrence, plain loop
    ("rwkv6-1.6b", {"rwkv_impl": "chunked", "rwkv_chunk": 8}),
    ("recurrentgemma-2b", None),      # RG-LRU + conv + local attn, tail
    ("seamless-m4t-large-v2", None),  # enc-dec with cross-attention
]


@pytest.mark.parametrize("arch,options", CASES,
                         ids=[case_id(a, o) for a, o in CASES])
def test_model_matches_reference(arch, options):
    check_model_matches_reference(arch, options)
