"""The port's `data/prefetch.py` (the background input-assembly thread):
the eight cases of the JAX package's `tests/test_prefetch.py` on the port's
module — ordering, the window and stack transforms, exception
propagation, the resume skip, and the producer's prompt stop on close() or
abandonment — and the same windows as the JAX functions from the same
batches.
"""

import threading
import time

import numpy as np
import pytest

from distributed_pytorch_from_scratch_tpu.data import prefetch as jprefetch
from distributed_pytorch_from_scratch_tpu_torch.data.prefetch import (
    Prefetcher, stack_window, window_stream)
from _torch_threads import two_torch_threads  # noqa: F401



def _batch(i, rows=2, width=4):
    return {k: np.full((rows, width), i + off, np.int32)
            for off, k in enumerate(("input_ids", "target_ids",
                                     "position_ids"))}


def test_window_stream_groups_and_skips():
    wins = list(window_stream((_batch(i) for i in range(7)), 3, skip=1))
    assert [len(w) for w in wins] == [3, 3]  # 6 after skip -> 2 full windows
    assert wins[0][0]["input_ids"][0, 0] == 1  # batch 0 skipped


def test_window_stream_yields_final_partial():
    wins = list(window_stream((_batch(i) for i in range(5)), 3))
    assert [len(w) for w in wins] == [3, 2]


def test_stack_window_shapes():
    stacked = stack_window([_batch(0), _batch(1)])
    assert stacked["input_ids"].shape == (2, 2, 4)
    np.testing.assert_array_equal(stacked["input_ids"][1], _batch(1)["input_ids"])


def test_prefetcher_preserves_order_and_counts_waits():
    src = [_batch(i) for i in range(9)]
    pf = Prefetcher(iter(src), depth=2)
    got = list(pf)
    assert len(got) == 9
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["input_ids"], src[i]["input_ids"])
    assert pf.pulls == 10  # 9 items + the DONE sentinel
    assert pf.wait_time >= 0.0


def test_prefetcher_applies_transform_on_thread():
    tids = set()

    def tf(item):
        tids.add(threading.get_ident())
        return item

    list(Prefetcher(iter([_batch(0), _batch(1)]), transform=tf))
    assert tids and threading.get_ident() not in tids


def test_prefetcher_propagates_exceptions():
    def gen():
        yield _batch(0)
        raise RuntimeError("boom in producer")

    pf = Prefetcher(gen())
    assert next(iter(pf))["input_ids"][0, 0] == 0
    with pytest.raises(RuntimeError, match="boom in producer"):
        next(iter(pf))


def test_prefetcher_close_stops_abandoned_producer():
    started = threading.Event()

    def endless():
        started.set()
        i = 0
        while True:
            yield _batch(i % 100)
            i += 1

    pf = Prefetcher(endless(), depth=2)
    started.wait(5)
    next(iter(pf))
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive(), "producer must exit after close()"


def test_prefetcher_overlaps_slow_producer():
    """While the consumer processes item N, the producer assembles N+1: the
    consumer's second pull must not pay the full production cost."""
    delay = 0.15

    def slow():
        for i in range(3):
            time.sleep(delay)
            yield _batch(i)

    pf = Prefetcher(slow(), depth=2)
    it = iter(pf)
    next(it)                      # producer starts on item 1 immediately
    time.sleep(delay * 1.5)       # consumer "works"; item 1 lands meanwhile
    w0 = pf.wait_time
    next(it)
    assert pf.wait_time - w0 < delay / 2, (
        f"second pull waited {pf.wait_time - w0:.3f}s — no overlap")


@pytest.mark.parametrize("size,skip", [(1, 0), (3, 2), (4, 5)])
def test_windows_match_jax(size, skip):
    """window_stream + stack_window through the prefetch thread give the
    JAX functions' windows, byte for byte."""
    src = [_batch(i, rows=3, width=5) for i in range(11)]
    ours = list(Prefetcher(window_stream(iter(src), size, skip),
                           transform=stack_window))
    theirs = [jprefetch.stack_window(w)
              for w in jprefetch.window_stream(iter(src), size, skip)]
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
