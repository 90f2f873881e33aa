"""The device timeline: busy time as a union over the window and over
the requests, labelled gaps, and the refusal of a short event list."""
import pytest

from nkbench.trace import Spans, Timeline, reduce


def test_union_counts_overlap_once_over_the_window():
    spans = Spans()
    spans.add("request", 0, 100)
    spans.add("between requests", 100, 200)
    spans.add("request", 200, 260)
    iv = [(0, 10, "a"), (5, 20, "b"), (30, 40, "c"), (150, 160, "d"),
          (35, 38, "e"), (250, 270, "f"), (-5, -1, "before")]
    t = reduce(iv, spans, (0, 260))
    assert t.events == 6  # "before" ran before the window
    assert t.window_s == pytest.approx(260e-9)
    # a..c: 20 + 10; d: 10; f cut at the window's end: 10
    assert t.busy_s == pytest.approx(50e-9)
    assert t.request_s == pytest.approx(160e-9)
    assert t.request_busy_s == pytest.approx(40e-9)  # d is between them
    # each gap labelled by the span open where it starts
    assert t.gaps == [("request: c -> d", pytest.approx(110e-9)),
                      ("between requests: d -> f", pytest.approx(90e-9)),
                      ("request: b -> c", pytest.approx(10e-9))]
    assert t.kernel_seconds("a") == (pytest.approx(10e-9), 1)
    bd = t.breakdown()
    assert bd["device_ops"][0][0] in ("f", "b", "d")
    assert len(bd["idle_gaps"]) == 3


def test_a_short_event_list_is_refused():
    spans = Spans()
    spans.add("request", 0, 5)
    t = reduce([(0, 1, "k")], spans, (0, 5))
    t.check(1, "one a request")
    with pytest.raises(RuntimeError, match="under-read"):
        t.check(2, "one a request")
    with pytest.raises(RuntimeError):
        t.check_kernel(0, 3, "cheb_pass")
    assert isinstance(t, Timeline)
