"""``nbodyax_torch.graphs.capture``, the capture sequence the driver's graph
windows and the graphed gradient share, on the CPU: the card's stream and
graph calls are stood in for by objects that run the captured body once,
so what is checked is the launch-count bookkeeping and the errors, not a
capture. Card-only captures are tested in tests/test_torch_graphs.py and
tests/test_torch_autodiff_graph.py.
"""

import contextlib

import pytest

torch = pytest.importorskip("torch")

from nbodyax_torch import autodiff, graphs  # noqa: E402
from nbodyax_torch.physics.kernels import tile_accumulators_raw  # noqa: E402
from nbodyax_torch.physics.kernels_bwd import raw_backward  # noqa: E402
from nbodyax_torch.state import make_state  # noqa: E402


class FakeStream:
    def wait_stream(self, other):
        pass


class FakeGraph:
    pass


@pytest.fixture
def no_card(monkeypatch):
    """torch.cuda's stream and graph calls as stand-ins that run the body."""
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **k: contextlib.nullcontext())
    monkeypatch.setattr(tile_accumulators_raw, "launches", 100)
    monkeypatch.setattr(raw_backward, "launches", 7)


def launch(b1=0, b2=0):
    tile_accumulators_raw.launches += b1
    raw_backward.launches += b2


def counts():
    return graphs.read_counters()[:2]


def test_delta_is_the_capture_s_launches_and_counts_stay(no_card):
    def warm_up():
        launch(b1=5, b2=5)
        return "warm"

    def body(warm):
        assert warm == "warm"
        launch(b1=2, b2=1)
        return "out"

    graph, out, delta = graphs.capture(body, warm_up, "a test")
    assert isinstance(graph, FakeGraph) and out == "out"
    assert delta == [2, 1, 0, 0, 0, 0]
    assert counts() == [100, 7]
    graphs.add_counts(delta)
    assert counts() == [102, 8]


@pytest.mark.parametrize("where", ["warm-up", "capture"])
def test_counts_stay_when_warm_up_or_capture_raises(no_card, where):
    """A warm-up that raises (bh's NotImplementedError, say, which the
    warm-up meets before any capture) or a body that raises something
    other than a capture's RuntimeError leaves the counts as they were and
    raises it as is."""
    exc = NotImplementedError if where == "warm-up" else ValueError

    def fail():
        launch(b1=3, b2=2)
        raise exc("no gradient")

    with pytest.raises(exc):
        if where == "warm-up":
            graphs.capture(lambda w: None, fail, "a test")
        else:
            graphs.capture(lambda w: fail(), lambda: launch(b1=1), "a test")
    assert counts() == [100, 7]


def test_a_failed_capture_raises_graph_capture_error(no_card):
    def body(warm):
        launch(b1=1)
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    with pytest.raises(graphs.GraphCaptureError,
                       match="capturing a test's CUDA graph failed"):
        graphs.capture(body, lambda: launch(b1=1), "a test")
    assert counts() == [100, 7]


def test_the_driver_re_exports_graph_capture_error():
    from nbodyax_torch import driver
    assert driver.GraphCaptureError is graphs.GraphCaptureError


@pytest.mark.parametrize("fail", [False, True], ids=["captures", "raises"])
def test_the_gradient_captures_through_graphs_capture(no_card, fail):
    """The graphed gradient's capture goes through ``graphs.capture``: a
    replay adds what its capture launched, and a loss that raises in the
    warm-up leaves the counts as they were."""
    st = make_state([[0.0, 0.0], [3.0, 4.0]], [[0.0, 0.0], [0.0, 0.0]],
                    [1.0, 2.0], [0.1, 0.1], device="cpu")

    def loss(s):
        launch(b1=2, b2=1)
        if fail:
            raise NotImplementedError("forward-only")
        return (s.pos ** 2).sum() * s.mass.sum()

    vg = autodiff.graphed_value_and_grad(loss, wrt=("pos",))
    if fail:
        with pytest.raises(NotImplementedError):
            vg._capture(st, None)
        assert counts() == [100, 7] and vg.graph is None
        return
    vg._capture(st, None)
    assert counts() == [100, 7] and vg.delta[:2] == [2, 1]
    value, (g,) = vg.out
    assert torch.equal(value, torch.tensor(75.0))
    assert torch.equal(g, 6.0 * st.pos)
