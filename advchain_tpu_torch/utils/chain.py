"""random_chain — sample a random sub-chain of transforms each step (port
of advchain_tpu/utils/chain.py).

Reference common/utils.py:180-212 is legacy-broken (undefined ``args`` for
single-element lists; the two-argument ``random.shuffle`` removed in Python
3.11).  This is the repaired behavior the README documents
(README.md:177-214): pick a random length in [1, max_length], shuffle, and
apply the SAME permutation to ``size_list`` when given.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["random_chain"]


def random_chain(alist: Sequence, max_length: Optional[int] = None,
                 size_list: Optional[Sequence] = None, rng=None):
    """Return a random sub-chain (and the matching sizes when given).

    ``rng``: optional ``numpy.random.RandomState``/``Generator`` for
    reproducibility; defaults to the global numpy RNG like the reference.
    """
    if rng is None:
        rng = np.random
    length = len(alist)
    assert length >= 1, "input list must contain at least one element"
    if max_length is None:
        max_length = length
    else:
        max_length = min(max_length, length)
    if length == 1:
        if size_list is not None:
            assert len(size_list) == 1, "must share equal size"
            return [alist[0]], [size_list[0]]
        return [alist[0]]
    sub_len = int(rng.randint(1, max_length + 1))
    perm = rng.permutation(length)
    shuffled = [alist[i] for i in perm]
    if size_list is not None and len(size_list) >= 0:
        assert len(size_list) == length, "must share equal size"
        shuffled_sizes = [size_list[i] for i in perm]
        return shuffled[:sub_len], shuffled_sizes[:sub_len]
    return shuffled[:sub_len]
