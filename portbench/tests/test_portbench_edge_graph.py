"""The ``edge_graph_share`` reader: the share of the window's AR batches
whose front edge ran as the replay of its CUDA graph, read from the
program's ``translator.graph_edge_passes`` and ``translator.edge_passes``
counters; a program without them gives nothing to read."""

import types

import pytest

from run_readers import read


def _ctx(counts):
    return types.SimpleNamespace(counts=counts)


@pytest.mark.parametrize("name", ["edge_graph_share.serve",
                                  "edge_graph_share.latency"])
def test_edge_graph_share_reader(name):
    # every batch of the window replayed its edge
    assert read(name, _ctx({"translator.edge_passes": 120,
                            "translator.graph_edge_passes": 120})) \
        == pytest.approx(100)
    assert read(name, _ctx({"translator.edge_passes": 120,
                            "translator.graph_edge_passes": 90})) \
        == pytest.approx(75)
    # edges run eagerly (the CPU, a dense decode) read 0
    assert read(name, _ctx({"translator.edge_passes": 120,
                            "translator.graph_edge_passes": 0})) == 0
    # the parent program has neither counter, or the window no batch
    assert read(name, _ctx({"translator.beam_steps": 400})) is None
    assert read(name, _ctx({"translator.edge_passes": 120})) is None
    assert read(name, _ctx({"translator.edge_passes": 0,
                            "translator.graph_edge_passes": 0})) is None
    assert read(name, _ctx({})) is None
