"""The profiler guard on fake event lists: a window that lost events is
discarded and taken again, and one that keeps losing gives no number."""

import pytest

from portbench.harness import profiling


def test_lost_names_what_is_missing():
    names = ["beam_kernel<8>", "attn_kernel", "attn_kernel", "logmel_kernel"]
    assert profiling.lost([], {"beam_kernel": 1}) == "no device event"
    assert profiling.lost(names, {"beam_kernel": 1, "attn_kernel": 2}) is None
    assert profiling.lost(names, {"beam_kernel": 2}) == "1 launches of beam_kernel, 2 counted"
    # kernel 4's score pass is not kernel 2
    assert profiling.lost(names + ["attn_bf16_kernel"], {"attn_kernel": 2}) is None


def test_window_busy_idle_and_gaps():
    dev = [("a", 0, 10), ("b", 5, 20), ("a", 40, 50), ("c", 90, 100)]
    spans = [("vad", 15, 45), ("transcription", 45, 100), ("window", 0, 100)]
    w = profiling.Window(dev, spans, 0, 100)
    assert w.busy_s == pytest.approx(40e-6)
    assert w.window_s == pytest.approx(100e-6)
    assert w.kernel_s("a") == pytest.approx(20e-6)
    assert w.top_ops(2) == [["a", pytest.approx(20e-6)], ["b", pytest.approx(15e-6)]]
    assert w.idle_gaps() == [["transcription", pytest.approx(40e-6)], ["vad", pytest.approx(20e-6)]]


def _fake_profiler(monkeypatch, windows):
    """profiling.profile over a scripted list of (device names, wrapper counts)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    script = iter(windows)

    def take(fn):
        names, counts = next(script)
        fn()
        dev = [(n, i, i + 1) for i, n in enumerate(names)]
        return dev, [("window", 0, len(names) + 1)], counts

    monkeypatch.setattr(profiling, "_take_window", take)


def test_a_lost_window_is_taken_again(monkeypatch):
    _fake_profiler(monkeypatch, [([], {"beam_kernel": 1}),
                                 (["beam_kernel"], {"beam_kernel": 2}),
                                 (["beam_kernel", "beam_kernel"], {"beam_kernel": 2})])
    calls = []
    w, counts = profiling.profile(lambda: calls.append(1), pause_s=0, log=lambda m: None)
    assert w is not None and len(calls) == 3 and counts == {"beam_kernel": 2}


def test_windows_that_keep_losing_give_nothing(monkeypatch):
    _fake_profiler(monkeypatch, [(["x"], {"beam_kernel": 1})] * profiling.WINDOWS)
    w, counts = profiling.profile(lambda: None, pause_s=0, log=lambda m: None)
    assert w is None and counts is None
