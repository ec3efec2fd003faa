"""The port's comm.add_listener / remove_listener contract, held to the
reference's cases (tests/test_comm_listeners.py): registration order,
exception safety (a raising listener cannot corrupt the ledger or starve
other listeners; the first exception wins), nested ``track()``, removal
by ``listening``, the summary; then ``estimate_cost`` on meta tensors and
the per-query firing of the eager port."""
import pytest
import torch

from repro.core import comm as jcomm
from repro_torch.core import comm


@pytest.fixture(autouse=True)
def _no_leaked_listeners():
    before = list(comm._LISTENERS)
    yield
    assert comm._LISTENERS == before, "test leaked a comm listener"


def test_listener_sees_every_record_in_order():
    seen = []
    with comm.listening(lambda *a: seen.append(("a",) + a)), \
            comm.listening(lambda *a: seen.append(("b",) + a)):
        comm.record("x.fc", 1, 100)
        comm.record("y.fc", 2, 200, preprocess=True)
    # both fire per record, in registration order
    assert seen == [("a", "x.fc", 1, 100, False),
                    ("b", "x.fc", 1, 100, False),
                    ("a", "y.fc", 2, 200, True),
                    ("b", "y.fc", 2, 200, True)]
    # fires even with no tracking ledger active (documented behaviour)


def test_listener_fires_under_nested_track_top_ledger_only():
    seen = []
    with comm.listening(lambda tag, r, b, pre: seen.append(tag)):
        with comm.track() as outer:
            comm.record("outer.op", 1, 10)
            with comm.track() as inner:
                comm.record("inner.op", 1, 20)
        # the listener observed both records...
        assert seen == ["outer.op", "inner.op"]
        # ...but each ledger only accounted its own scope (top-of-stack)
        assert dict(outer.by_tag) == {"outer.op": [1, 10]}
        assert dict(inner.by_tag) == {"inner.op": [1, 20]}


def test_raising_listener_still_feeds_ledger_and_other_listeners():
    seen = []

    def bad(tag, r, b, pre):
        raise ValueError("boom")

    with comm.listening(bad), \
            comm.listening(lambda tag, r, b, pre: seen.append(tag)):
        with comm.track() as led:
            with pytest.raises(ValueError, match="boom"):
                comm.record("x.fc", 1, 100)
    # the later listener still fired and the accounting is intact
    assert seen == ["x.fc"]
    assert led.rounds == 1 and led.nbytes == 100


def test_first_listener_exception_wins():
    def bad1(tag, r, b, pre):
        raise ValueError("first")

    def bad2(tag, r, b, pre):
        raise RuntimeError("second")

    with comm.listening(bad1), comm.listening(bad2):
        with pytest.raises(ValueError, match="first"):
            comm.record("x", 1, 1)


def test_listening_removes_on_exception():
    fn = lambda *a: None  # noqa: E731
    with pytest.raises(RuntimeError, match="escape"):
        with comm.listening(fn):
            assert fn in comm._LISTENERS
            raise RuntimeError("escape")
    assert fn not in comm._LISTENERS


def test_remove_listener_unknown_raises():
    with pytest.raises(ValueError):
        comm.remove_listener(lambda *a: None)


def test_round_barrier_records_through_listeners():
    tags = []
    with comm.listening(lambda tag, r, b, pre: tags.append(tag)):
        with comm.track() as led:
            with comm.round_barrier("relu0", 2):
                comm.record("relu0.ot", 1, 50)
                comm.record("relu0.ot", 1, 50)
    # the nested records reached the listener; the barrier collapsed the
    # ledger's round count to the stated 2
    assert tags == ["relu0.ot", "relu0.ot"]
    assert led.by_tag["relu0"] == [2, 100]


def test_summary_sorted_by_online_bytes_desc_with_pct():
    led = comm.CommLedger()
    led.add("small", 1, 100)
    led.add("big", 2, 900)
    led.add("off", 1, 500, preprocess=True)
    lines = led.summary().splitlines()
    body = [ln.strip() for ln in lines[1:]]
    assert body[0].startswith("big"), body
    assert body[1].startswith("small"), body
    assert body[2].startswith("pre:off"), body
    assert "( 90.0%)" in body[0]
    assert "( 10.0%)" in body[1]
    assert "(100.0%)" in body[2]   # pct of the offline total


def test_summary_zero_total_no_division_error():
    led = comm.CommLedger()
    led.add("z", 1, 0)
    assert "(  0.0%)" in led.summary()


def test_summary_equals_reference():
    """The same records give the reference's summary text, exactly."""
    rows = [("l0.fc", 1, 300), ("sign1.msb", 1, 600), ("l0.fc", 0, 12),
            ("b2a", 2, 96, True)]
    outs = []
    for mod in (comm, jcomm):
        with mod.track() as led:
            for r in rows:
                mod.record(*r)
        outs.append(led.summary())
    assert outs[0] == outs[1]


def test_estimate_cost_moves_every_tensor_to_meta():
    """Tensors inside RSS, lists and dicts reach ``fn`` on ``meta``; the
    ledger is what the protocols record."""
    from repro_torch.core.ring import RING32
    from repro_torch.core.rss import RSS
    seen = []

    def fn(x, extra, *, opts):
        seen.extend([x.shares.device.type, extra[0].device.type,
                     opts["w"].device.type])
        comm.record("l0.fc", 1, 4 * x.shares[0].numel())
        return x

    x = RSS(torch.ones(3, 2, 5, dtype=torch.int32), RING32)
    led = comm.estimate_cost(fn, x, [torch.zeros(4)],
                             opts={"w": torch.zeros(2)})
    assert seen == ["meta"] * 3
    assert (led.rounds, led.nbytes) == (1, 40)
    assert x.shares.device.type == "cpu"   # the caller's tensors stay


def test_listener_fires_on_every_query():
    """The eager port records as it runs: a listener sees each query's
    ops, where the reference's fire once per traced program."""
    from repro_torch.core import linear, prf
    from repro_torch.core.randomness import Parties
    from repro_torch.core.rss import share
    x = share(torch.ones(4), prf.PRNGKey(0))
    tags = []
    with comm.listening(lambda tag, r, b, pre: tags.append(tag)):
        for _ in range(3):
            linear.reveal(x, tag="out")
            linear.truncate(x, Parties.setup(prf.PRNGKey(1)), tag="tr")
    assert tags == ["out", "tr"] * 3
