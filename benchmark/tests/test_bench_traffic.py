"""The traffic generator: request i is a function of (seed, i); every seed
sends the same set of prompt lengths, in an order of its own."""

import numpy as np
import torch

from benchmark import manifest
from benchmark.generator import Traffic
from benchmark.harness import Sample
from benchmark.weights import derive

SEED = 2 ** 31 + 12345  # wider than 32 signed bits


def mix(name):
    return manifest.cell(name).traffic


def test_same_seed_same_requests_and_noise():
    a, b = Traffic(mix("gen-b1"), SEED, 32128), Traffic(mix("gen-b1"), SEED, 32128)
    for i in (0, 5, 77):
        ra, rb = a.request(i), b.request(i)
        assert np.array_equal(ra.ids, rb.ids) and ra.guidance == rb.guidance == 4.0
        assert torch.equal(a.noise(i, (1, 4, 4, 8), "cpu"), b.noise(i, (1, 4, 4, 8), "cpu"))
    assert not torch.equal(a.noise(1, (1, 4, 4, 8), "cpu"), a.noise(2, (1, 4, 4, 8), "cpu"))
    c = Traffic(mix("gen-b1"), SEED + 1, 32128)
    assert not np.array_equal(a.request(3).ids, c.request(3).ids)


def test_every_seed_sends_the_same_lengths():
    cycles = []
    for seed in (1, SEED, 2 ** 40 + 7):
        t = Traffic(mix("gen-b1"), seed, 32128)
        lengths = [t.request(i).length for i in range(33)]
        assert sorted(lengths) == list(range(8, 41))
        assert [t.request(i + 33).length for i in range(33)] == lengths
        cycles.append(lengths)
    assert cycles[0] != cycles[1]


def test_bulk_mix_shapes_and_vocabulary():
    t = Traffic(mix("gen-b32"), SEED, 32128)
    r = t.request(4)
    assert r.ids.shape == (32, 64) and r.ids.min() >= 2 and r.ids.max() < 32000
    assert (r.mask == 1).all() and (r.uncond_ids == 1).all()
    tiny = Traffic(mix("gen-b32"), SEED, 256)
    assert tiny.request(0).ids.max() < 256


def test_sample_keeps_k_drawn_from_the_seed_and_the_longest():
    """The window's outputs kept for the check: the k requests of lowest
    priority drawn from (seed, request) and, of the longest ones, the one of
    lowest priority; nothing else on the host at any point. Where every
    request is as long, that one is among the k."""
    t = Traffic(mix("gen-b1"), SEED, 32128)
    prio = lambda i: derive(SEED, "check", i)  # noqa: E731
    s = Sample(SEED, 8)
    for i in range(200):
        s.offer(i, t.request(i).length, f"out{i}")
        assert len(s.outputs) <= 9 and set(s.outputs) == set(s.picked())
    lowest = sorted(range(200), key=prio)[:8]
    longest = min((i for i in range(200) if t.request(i).length == 40), key=prio)
    assert s.picked() == sorted(set(lowest) | {longest})
    assert all(s.outputs[i] == f"out{i}" for i in s.picked())
    other = Sample(SEED + 1, 8)
    for i in range(200):
        other.offer(i, t.request(i).length, i)
    assert other.picked() != s.picked()
    same = Sample(SEED, 1)
    for i in range(50):
        same.offer(i, 64, i)
    assert same.picked() == [min(range(50), key=prio)] and len(same.outputs) == 1
