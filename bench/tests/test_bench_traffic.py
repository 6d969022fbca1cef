"""The traffic generator: fixed sizes shuffled by the seed, tokens drawn
from the seed, large seeds."""
import numpy as np

from bench.tests import smallcells  # noqa: F401  (paths)
from bench.harness import traffic

BIG = 2**31 + 2**33 + 12345


def test_fixed_set_is_the_distributions_midpoints():
    u = traffic.fixed_set({"dist": "uniform", "lo": 8, "hi": 64}, 57)
    assert list(u) == list(range(8, 65))
    lg = traffic.fixed_set({"dist": "loguniform", "lo": 64, "hi": 512}, 3)
    assert list(lg) == [int(round(64 * 2 ** (3 * q))) for q in (1/6, .5, 5/6)]


def test_every_seed_and_unit_has_the_same_sizes():
    mix = {"requests": 64, "wave": 16, "pad_to": 64, "pad_token": 0,
           "prompt_len": {"dist": "uniform", "lo": 32, "hi": 64},
           "gen_len": {"dist": "loguniform", "lo": 8, "hi": 64}}
    a = traffic.gen_batch(mix, 1000, BIG, 0)
    b = traffic.gen_batch(mix, 1000, 7, 0)
    c = traffic.gen_batch(mix, 1000, BIG, 0)
    assert list(a.gen_lens) == list(b.gen_lens)
    assert list(a.prompt_lens) == list(b.prompt_lens)
    assert list(a.gen_lens) != sorted(a.gen_lens)
    assert not np.array_equal(a.prompts, b.prompts)
    assert np.array_equal(a.prompts, c.prompts)
    assert not np.array_equal(a.prompts,
                              traffic.gen_batch(mix, 1000, BIG, 1).prompts)
    for row, p in zip(a.prompts, a.prompt_lens):
        assert (row[:64 - p] == 0).all() and (row[64 - p:] > 0).all()
    assert a.max_new_tokens == 64


def test_warm_batch_has_the_mix_shapes():
    mix = {"requests": 64, "wave": 16, "pad_to": 128,
           "gen_len": {"dist": "uniform", "lo": 8, "hi": 64}}
    w = traffic.warm_batch(mix, 500, BIG)
    assert w.prompts.shape == (17, 128) and w.max_new_tokens == 64
    assert w.gen_lens.max() > 1


def test_rl_prompts_hold_no_eos():
    mix = {"prompts": 8, "prompt_len": 128, "eos_token": 12,
           "reward": {"classes": 4}}
    b = traffic.rl_batch(mix, 151936, BIG, 3)
    assert b.prompts.shape == (8, 128) and (b.prompts > 12).all()
    assert set(b.answers) <= {0, 1, 2, 3}
