"""The port's plain witness evaluator on the depth-20 multi-message-id graph
(max_out 4: Neg, Neq, TernCond and two Div groups besides the single
graph's ops), lane by lane against the host interpreter, as
tests/test_torch_witness_depth20_single.py does for the single graph."""

import torch

from test_torch_witness_depth20_single import check_graph_against_host

torch.set_num_threads(1)


def test_depth20_multi_matches_host():
    check_graph_against_host("tree_depth_20/multi_message_id/max_out_4/graph.bin", 4, multi=True)
