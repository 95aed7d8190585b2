"""The benchmark's frozen generator gives the project's corpus."""
import numpy as np
import pytest

from codecbench.data.mixed_corpus import make_corpus, make_pool


@pytest.mark.parametrize("seed", [0, 42, 2 ** 31 + 17])
def test_make_corpus_equals_chip_smoke(seed):
    from chip_smoke import make_corpus as original

    for n in (8 << 20, 4099, 1000):
        rng_a, rng_b = (np.random.default_rng((seed, 3)) for _ in range(2))
        assert make_corpus(rng_a, n) == original(rng_b, n)


def test_pool_is_a_function_of_the_seed():
    a = make_pool(2 ** 33 + 1, 3, 4096)
    assert a == make_pool(2 ** 33 + 1, 3, 4096)
    assert len(set(a)) == 3 and all(len(c) == 4096 for c in a)
    assert make_pool(2 ** 33 + 2, 3, 4096) != a
