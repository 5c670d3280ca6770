"""tools/profile_slice.profile_calls discards a profiler window that lost
events and takes it again; after PROFILE_WINDOWS lost windows it raises.

The profiler itself needs the card, so each window is a list of fake device
events here: a window with no device event lost its events, and with
`expect` a window with another count than `reps` launches lost calls.
"""

import types

import pytest

from sherpa_vietnamese_asr_tpu_torch.tools import profile_slice, profiler_loss, skew_bf16


def _event(name, start, end):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(
            start=start, end=end, elapsed_us=lambda: end - start))


def _window(launches, name="attn_kernel<0>", other=1):
    """`launches` calls of a 10 us kernel and `other` 5 us copies."""
    events = [_event(name, 100 * i, 100 * i + 10) for i in range(launches)]
    return events + [_event("Memcpy HtoD", 100 * i + 50, 100 * i + 55) for i in range(other)]


def _fake_windows(monkeypatch, windows):
    taken = []

    def window(fn, reps):
        taken.append(reps)
        return windows[len(taken) - 1]

    monkeypatch.setattr(profile_slice, "_profile_window", window)
    monkeypatch.setattr(profile_slice.time, "sleep", lambda s: None)
    return taken


@pytest.mark.parametrize("lost", [
    [],                                   # the first window is kept
    [[]],                                 # one window saw no device event
    [[], [], _window(6)],                 # a burst: all lost, then calls lost
    [_window(9), _window(0, other=3)],    # too many, then none of the kernel
])
def test_lost_windows_are_retaken(monkeypatch, lost):
    taken = _fake_windows(monkeypatch, lost + [_window(7)])
    busy, per_name, counts = profile_slice.profile_calls(lambda: None, reps=7,
                                                         expect="attn_kernel")
    assert len(taken) == len(lost) + 1
    assert counts == {"attn_kernel<0>": 7, "Memcpy HtoD": 1}
    assert per_name["attn_kernel<0>"] == pytest.approx(10 * 7 / 1e3 / 7)
    assert busy == pytest.approx((7 * 10 + 5) / 1e3 / 7)


def test_without_expect_only_an_empty_window_is_lost(monkeypatch):
    taken = _fake_windows(monkeypatch, [[], _window(3)])
    _, _, counts = profile_slice.profile_calls(lambda: None, reps=7)
    assert len(taken) == 2 and counts["attn_kernel<0>"] == 3


@pytest.mark.parametrize("window", [[], _window(6)])
def test_every_window_lost_raises(monkeypatch, window):
    taken = _fake_windows(monkeypatch, [window] * profile_slice.PROFILE_WINDOWS)
    with pytest.raises(RuntimeError, match="lost events in each of"):
        profile_slice.profile_calls(lambda: None, reps=7, expect="attn_kernel")
    assert len(taken) == profile_slice.PROFILE_WINDOWS


def test_device_ms_reads_the_kept_window(monkeypatch):
    _fake_windows(monkeypatch, [[], _window(10)])
    ms, seen = skew_bf16.device_ms(lambda: None, 10)
    assert seen == 10 and ms == pytest.approx(0.01)


@pytest.mark.parametrize("flags,run", [
    ([], 0), ([False, False], 0), ([True], 1),
    ([False, True, True, False, True, True, True, False], 3),
])
def test_profiler_loss_longest_run(flags, run):
    assert profiler_loss.longest_run(flags) == run
