"""The residual stream's sequence split (``res_seq``) of the
decoder-only stack over 4 gloo processes, and the split's fallbacks,
against the JAX package's single-device step.

One module-scoped run starts 4 processes of ``tests/torch_tp_worker.py``
(part ``seq``; a file rendezvous under tmp_path; killed after 300 s)
while this process runs the JAX package's steps; each case trains 3
steps under the tp profile from the JAX package's initial state, held
as in ``tests/test_torch_tp_train_families.py`` (metrics 1e-5, step-1
gradients 1e-4, ``SPLIT_SEEN``, the leaves gathered whole):

  * camformer-bert smoke with a plain GELU MLP and layer norms on
    make_mesh_for(4, 2): each process holds 32 of the 64 rows of the
    residual stream between blocks (the norms, their biases and
    ``b_out`` run on those rows, their gradients summed over ``model``),
    its heads and MLP columns on the gathered sequence.  On the dense
    backend: on camformer this variant's unsplit loss already differs
    from the reference's by 2e-4 (a binarized component near zero takes
    the other sign); camformer-bert smoke on camformer under
    ``res_seq`` is ``tests/test_torch_tp_train.py``'s case;
  * the ``kv_seq`` fallback: camformer-bert smoke with 6 heads on
    make_mesh_for(4, 4): 6 heads do not divide 4, so the attention runs
    whole (the reference's resolver replicates it too: no rule table has
    ``att_kv_seq``), on the gathered sequence, while the MLP splits and
    the stream holds 16 rows a process;
  * the ``res_seq`` fallback: llava-next smoke, 8 patches and 55 tokens,
    P + S = 63 rows that 2 does not divide: whole rows, as the
    resolver's fallback gives.
"""

import pytest

from test_torch_tp_train_families import check_case, start
from torch_tp_worker import SEQ_CASES


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return start(tmp_path_factory, "seq", SEQ_CASES)


ATTN = {"wq", "wk", "wv", "wo"}
CASES = {
    "res_seq_gelu_layer_norm": (dict(attn_q_heads=2, attn_kv_heads=2,
                                     mlp_cols=48, vocab_rows=128,
                                     res_rows=32), set()),
    "kv_seq": (dict(attn_whole_heads=6, mlp_cols=24, vocab_rows=64,
                    res_rows=16), ATTN),
    # MQA 4 on 1 at smoke width: qheads, the kv head whole
    "vlm_odd": (dict(attn_q_heads=2, attn_kv_heads=2, mlp_cols=48,
                     vocab_rows=128), {"wk", "wv"}),
}


@pytest.mark.parametrize("name", [c[0] for c in SEQ_CASES])
def test_res_seq_step_matches_single_device(ranks, name):
    seen, whole = CASES[name]
    check_case(ranks, name, seen, whole)
