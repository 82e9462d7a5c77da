"""The coalescing front: lightgbm_tpu_torch.serving.ServingFront on the
CPU.

A coalesced request's scores are bitwise those of its rows scored alone
(rows are independent through the walk and the per-class sums); the
bounded queue blocks instead of shedding; a swap flips engines between
requests and never loses or splits one; a swap that times out is
withdrawn; ``close`` scores what is queued; an engine error reaches
every request of its batch; a cancelled request does not stop the
worker.  The model is a small port booster (600 rows, 6 features, 15
leaves, 4 iterations) and the engines run on the CPU.  Every wait has a
timeout, so a hang fails a test instead of stalling the suite.
"""
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import lifecycle, serving

WAIT = 30.0


@pytest.fixture(autouse=True)
def no_leaked_threads():
    """Every front a test starts is closed by its end."""
    yield
    leaked = lifecycle.leaks()
    for _kind, _name, closer in leaked:
        closer()
    assert not leaked, "left live: %s" % [(k, n) for k, n, _ in leaked]


@pytest.fixture(scope="module")
def booster():
    rng = np.random.RandomState(5)
    x = rng.randn(600, 6)
    y = (x[:, 0] - 0.7 * x[:, 1] + 0.3 * rng.randn(600) > 0)
    return lgt.train({"objective": "binary", "num_leaves": 15,
                      "num_iterations": 4, "min_data_in_leaf": 10},
                     lgt.Dataset.from_arrays(x, y.astype(np.float32)),
                     device="cpu"), x


class GatedEngine(serving.ServingEngine):
    """An engine whose ``scores`` waits for ``gate`` (set by default) and
    can be made to raise; ``entered`` is set once a call has begun."""

    def __init__(self, *args, fail=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.gate = threading.Event()
        self.gate.set()
        self.entered = threading.Event()
        self.fail = fail
        self.batches = []

    def scores(self, features):
        self.entered.set()
        assert self.gate.wait(WAIT), "gate never opened"
        self.batches.append(len(features))
        if self.fail is not None:
            raise self.fail
        return super().scores(features)


def _engine(booster, **kwargs):
    kwargs.setdefault("device", "cpu")
    return GatedEngine(booster.export_flat(), **kwargs)


def _wait_for(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, "timed out waiting for " + what
        time.sleep(0.002)


def test_coalesced_equals_alone(booster):
    b, x = booster
    eng = _engine(b, buckets=(1, 32, 1024), linger_us=200_000)
    sizes = [1, 5, 17, 3, 32, 9, 1, 12]
    with serving.ServingFront(eng) as front:
        eng.gate.clear()
        first = front.submit(x[:2])
        assert eng.entered.wait(WAIT)
        futs, ofs = [], 2
        for n in sizes:
            futs.append((front.submit(x[ofs:ofs + n]), ofs, n))
            ofs += n
        eng.gate.set()
        first.result(WAIT)
        alone = serving.ServingEngine(b.export_flat(), device="cpu")
        for fut, ofs, n in futs:
            got = fut.result(WAIT)
            assert got.shape == (1, n)
            np.testing.assert_array_equal(got, alone.scores(x[ofs:ofs + n]))
    # the eight queued while the first batch was on the engine coalesced
    # into batches of at most the top bucket
    assert front.stats["requests"] == 9 and front.stats["batches"] < 9
    assert max(eng.batches) <= 1024 and sum(eng.batches) == 2 + sum(sizes)


def test_backpressure_blocks_and_drops_nothing(booster):
    """queue=1 over a (1, 8) ladder holds 8 rows: a submit that would
    pass them blocks until the worker takes the queue."""
    b, x = booster
    eng = _engine(b, buckets=(1, 8), queue=1, linger_us=0)
    with serving.ServingFront(eng) as front:
        assert front.queue_rows == 8
        eng.gate.clear()
        head = front.submit(x[:8])
        assert eng.entered.wait(WAIT)
        queued = [front.submit(x[8 + i:9 + i]) for i in range(6)]
        done = threading.Event()
        late = []

        def blocked_submit():
            late.append(front.submit(x[20:24]))
            done.set()

        t = threading.Thread(target=blocked_submit)
        t.start()
        assert not done.wait(0.3), "submit did not block on a full queue"
        assert front.stats["queue_peak_rows"] == 8
        eng.gate.set()
        assert done.wait(WAIT)
        t.join(WAIT)
        assert not t.is_alive()
        alone = serving.ServingEngine(b.export_flat(), device="cpu")
        np.testing.assert_array_equal(head.result(WAIT), alone.scores(x[:8]))
        for i, fut in enumerate(queued):
            np.testing.assert_array_equal(fut.result(WAIT),
                                          alone.scores(x[8 + i:9 + i]))
        np.testing.assert_array_equal(late[0].result(WAIT),
                                      alone.scores(x[20:24]))
    assert front.stats["requests"] == 8 and front.stats["rows"] == 18


def test_swap_routes_before_and_after_the_marker(booster):
    b, x = booster
    old = _engine(b, linger_us=0)
    new = _engine(b, quantize="int8", linger_us=0)
    with serving.ServingFront(old) as front:
        old.gate.clear()
        before = [front.submit(x[i:i + 3]) for i in range(0, 12, 3)]
        assert old.entered.wait(WAIT)
        drains = []
        t = threading.Thread(target=lambda: drains.append(
            front.swap_engine(new)))
        t.start()
        _wait_for(lambda: any(isinstance(i, serving._SwapMarker)
                              for i in list(front._queue)), "the marker")
        after = [front.submit(x[i:i + 3]) for i in range(12, 24, 3)]
        old.gate.set()
        t.join(WAIT)
        assert not t.is_alive() and drains[0] >= 0
        assert front.engine is new and front.stats["swaps"] == 1
        f32 = serving.ServingEngine(b.export_flat(), device="cpu")
        i8 = serving.ServingEngine(b.export_flat(), quantize="int8",
                                   device="cpu")
        for i, fut in zip(range(0, 12, 3), before):
            np.testing.assert_array_equal(fut.result(WAIT),
                                          f32.scores(x[i:i + 3]))
        for i, fut in zip(range(12, 24, 3), after):
            np.testing.assert_array_equal(fut.result(WAIT),
                                          i8.scores(x[i:i + 3]))
        # int8 leaves score differently: the routing is visible
        assert not np.array_equal(f32.scores(x[12:24]), i8.scores(x[12:24]))
        np.testing.assert_array_equal(front.predict(x[:5], WAIT),
                                      i8.scores(x[:5]))


def test_swap_that_times_out_is_withdrawn(booster):
    b, x = booster
    old = _engine(b, linger_us=0)
    new = _engine(b, quantize="int8", linger_us=0)
    with serving.ServingFront(old) as front:
        old.gate.clear()
        pending = front.submit(x[:4])
        assert old.entered.wait(WAIT)
        with pytest.raises(TimeoutError, match="withdrawn"):
            front.swap_engine(new, timeout=0.1)
        assert not any(isinstance(i, serving._SwapMarker)
                       for i in list(front._queue))
        old.gate.set()
        alone = serving.ServingEngine(b.export_flat(), device="cpu")
        np.testing.assert_array_equal(pending.result(WAIT),
                                      alone.scores(x[:4]))
        np.testing.assert_array_equal(front.predict(x[4:9], WAIT),
                                      alone.scores(x[4:9]))
        assert front.engine is old and front.stats["swaps"] == 0
        assert not new.batches


def test_close_drains_the_queue(booster):
    b, x = booster
    eng = _engine(b, linger_us=0)
    front = serving.ServingFront(eng)
    assert lifecycle.tracked(front)
    eng.gate.clear()
    futs = [front.submit(x[i:i + 2]) for i in range(0, 20, 2)]
    assert eng.entered.wait(WAIT)
    closer = threading.Thread(target=front.close)
    closer.start()
    _wait_for(lambda: front._closed, "close")
    with pytest.raises(RuntimeError, match="closed"):
        front.submit(x[:1])
    eng.gate.set()
    closer.join(WAIT)
    assert not closer.is_alive() and not lifecycle.tracked(front)
    alone = serving.ServingEngine(b.export_flat(), device="cpu")
    for i, fut in zip(range(0, 20, 2), futs):
        np.testing.assert_array_equal(fut.result(WAIT),
                                      alone.scores(x[i:i + 2]))
    front.close()                          # closing twice is a no-op


def test_engine_error_reaches_every_request(booster):
    b, x = booster
    bad = _engine(b, linger_us=0, fail=RuntimeError("device lost"))
    with serving.ServingFront(bad) as front:
        bad.gate.clear()
        first = front.submit(x[:1])
        assert bad.entered.wait(WAIT)
        rest = [front.submit(x[i:i + 2]) for i in range(1, 9, 2)]
        bad.gate.set()
        for fut in [first] + rest:
            with pytest.raises(RuntimeError, match="device lost"):
                fut.result(WAIT)
        assert len(bad.batches) == 2        # the first, then the other 4
        # the worker lives on: the next request meets the next engine
        good = _engine(b, linger_us=0)
        front.swap_engine(good, timeout=WAIT)
        alone = serving.ServingEngine(b.export_flat(), device="cpu")
        np.testing.assert_array_equal(front.predict(x[:3], WAIT),
                                      alone.scores(x[:3]))


def test_cancelled_future_does_not_stop_the_worker(booster):
    b, x = booster
    eng = _engine(b, linger_us=0)
    with serving.ServingFront(eng) as front:
        eng.gate.clear()
        head = front.submit(x[:1])
        assert eng.entered.wait(WAIT)
        cancelled = front.submit(x[1:4])
        kept = front.submit(x[4:6])
        assert cancelled.cancel()
        eng.gate.set()
        alone = serving.ServingEngine(b.export_flat(), device="cpu")
        np.testing.assert_array_equal(head.result(WAIT), alone.scores(x[:1]))
        np.testing.assert_array_equal(kept.result(WAIT),
                                      alone.scores(x[4:6]))
        assert cancelled.cancelled()
        np.testing.assert_array_equal(front.predict(x[6:9], WAIT),
                                      alone.scores(x[6:9]))


def test_front_checks(booster):
    b, _ = booster
    eng = _engine(b)
    with pytest.raises(ValueError, match="queue must be >= 1"):
        serving.ServingFront(eng, queue=0)
    with serving.ServingFront(eng, linger_us=0, queue=2) as front:
        assert front.linger_s == 0 and front.queue_rows == 2 * 65536
        with pytest.raises(ValueError, match="rows, features"):
            front.submit(np.zeros(3))
