"""The ``graph_step_share`` reader: the share of the window's beam steps
that ran as the replay of their CUDA graph, read from the program's
``translator.graph_steps`` and ``translator.beam_steps`` counters; a
program without the graph counter gives nothing to read."""

import types

import pytest

from run_readers import read


def _ctx(counts):
    return types.SimpleNamespace(counts=counts)


@pytest.mark.parametrize("name", ["graph_step_share.serve",
                                  "graph_step_share.latency"])
def test_graph_step_share_reader(name):
    ctx = _ctx({"translator.beam_steps": 400,
                "translator.graph_steps": 396})
    assert read(name, ctx) == pytest.approx(99)
    # a decode that never engaged the graphs (CPU, dense) reads 0
    assert read(name, _ctx({"translator.beam_steps": 400,
                            "translator.graph_steps": 0})) == 0
    # the parent program has no such counter
    assert read(name, _ctx({"translator.beam_steps": 400})) is None
    assert read(name, _ctx({})) is None
