"""The ``bookkeeping_kernel_share`` reader: the bookkeeping kernel's
launches per beam step, read from the program's
``ops.beam_bookkeeping.launches`` and ``translator.beam_steps`` counters;
a program without the kernel's counter gives nothing to read."""

import types

import pytest

from run_readers import read


def _ctx(counts):
    return types.SimpleNamespace(counts=counts)


@pytest.mark.parametrize("name", ["bookkeeping_kernel_share.serve",
                                  "bookkeeping_kernel_share.latency"])
def test_bookkeeping_kernel_share_reader(name):
    ctx = _ctx({"translator.beam_steps": 400,
                "ops.beam_bookkeeping.launches": 400})
    assert read(name, ctx) == pytest.approx(100)
    assert read(name, _ctx({"translator.beam_steps": 400,
                            "ops.beam_bookkeeping.launches": 300})) \
        == pytest.approx(75)
    # a decode on the plain torch ops (CPU) reads 0
    assert read(name, _ctx({"translator.beam_steps": 400,
                            "ops.beam_bookkeeping.launches": 0})) == 0
    # the parent program has no such counter, or the window no step
    assert read(name, _ctx({"translator.beam_steps": 400})) is None
    assert read(name, _ctx({"ops.beam_bookkeeping.launches": 0})) is None
    assert read(name, _ctx({})) is None
