"""The dry run's regions (``repro_torch.launch.regions``) compute the plain
functions, on real DTensors over 4 gloo ranks in a 2 x 2 (data, model)
layout: attention with its K/V heads split or shared, decode attention over
batch rows and over cache slots (context parallel), SwiGLU, the
vocab-parallel cross entropy, logits and lookups, the in-batch softmax,
the sharded MoE (EP and ffTP, against ``moe_ffn`` a data row at a time),
AdamW on sharded leaves, and a reduced LM's train (two microbatches,
shared K/V heads, K/V heads that do not divide the model axis, padded
heads), prefill and decode cells, each output and
gradient held against the same call on plain tensors.  float32 throughout;
the tolerance is float32 summation order (rtol 1e-4, atol 1e-5)."""
import numpy as np
import pytest

from repro_torch.launch.mesh import spawn_ranks

CASES = ["attention_kv_split", "attention_kv_shared", "attention_kv_uneven",
         "attention_window_chunks", "decode_context_parallel",
         "decode_context_parallel_kv_shared", "decode_rows", "swiglu", "cross_entropy",
         "lookup_rows", "head_logits", "embedding_lookup", "per_field",
         "in_batch_softmax", "moe_expert_parallel", "moe_ff_parallel", "adamw",
         "lm_train_two_micro", "lm_train_kv_shared", "lm_train_kv_uneven",
         "lm_train_padded_heads", "lm_prefill", "lm_decode_rows",
         "lm_decode_context_parallel"]


@pytest.fixture(scope="module")
def ranks():
    from torch_dryrun_ranks import regions_rank
    return spawn_ranks(4, regions_rank, device="cpu", backend="gloo")


@pytest.mark.parametrize("case", CASES)
def test_region_equals_the_plain_function(ranks, case):
    for rank, out in enumerate(ranks):
        got, want = out[case]
        assert len(got) == len(want) > 0
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape, (rank, i)
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {rank}, output {i}")


def test_every_case_ran(ranks):
    assert all(set(out) == set(CASES) for out in ranks)
