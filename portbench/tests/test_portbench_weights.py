"""The weights makers at test size on the CPU: a seed gives the same
weights every time, and the EOS clock ends every caption, at lengths that
spread around the configuration's ``words`` from video to video."""

import collections

import torch

import tiny
from portbench import lookup
from portbench.devtrace import Tracer
from portbench.reference import care


def _weights(config, seed):
    cfg = tiny.config(config)
    m = cfg["model"]
    return lookup.module("weights", cfg["weights"]).make(
        care.param_shapes(m), seed, "cpu", m)


def test_a_seed_gives_the_same_weights():
    for config in ("msrvtt-care-vit", "msrvtt-care-vit-eos"):
        a, b = _weights(config, 2**31 + 41), _weights(config, 2**31 + 41)
        assert all(torch.equal(a[k], b[k]) for k in a)
        c = _weights(config, 2**31 + 42)
        assert not torch.equal(a["cls_head.tgt_word_prj.weight"],
                               c["cls_head.tgt_word_prj.weight"])


def test_eos_clock_ends_captions_around_its_words():
    cfg = tiny.config("msrvtt-care-vit-eos")
    m = cfg["model"]
    for key in ("max_len",):
        m[key] = cfg["set"][key] = 14
    m["eos_clock"]["words"] = 6
    mx = tiny.mix("serve.b64")
    mx.update(batch=16, pool_batches=4)
    d = lookup.module("drivers", "serve").Driver(cfg, mx, 2**31 + 43, "cpu")
    d.window(0.3, Tracer(False, "cpu"))
    ends = collections.Counter()
    for _, hyps, _ in d.results:
        for h in hyps:
            assert h[0][-1] == care.EOS
            ends[len(h[0]) - 1] += 1
    assert len(ends) >= 3, ends
    mean = sum(k * v for k, v in ends.items()) / sum(ends.values())
    assert 5 <= mean <= 9, ends
