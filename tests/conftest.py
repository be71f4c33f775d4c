"""Suite-wide guard rails.

* The multiprocessing start method is pinned to ``spawn`` so the suite
  behaves identically on linux (default fork) and macos (default spawn),
  and so no test accidentally depends on fork inheriting jax state —
  forking a process with a live XLA runtime is undefined behaviour.

* Every test runs under a wall-clock watchdog (SIGALRM timer in the main
  thread): a hung multiprocess transport test fails fast with a
  TimeoutError instead of wedging the whole CI workflow until the job
  timeout. Override per test with ``@pytest.mark.timeout_s(N)``; the
  default comes from ``REPRO_TEST_TIMEOUT`` (seconds, 0 disables).
"""
import multiprocessing
import os
import signal

import pytest

DEFAULT_TIMEOUT_S = float(os.environ.get("REPRO_TEST_TIMEOUT", "600"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "timeout_s(seconds): per-test wall-clock cap enforced by the "
        "conftest SIGALRM watchdog (default REPRO_TEST_TIMEOUT)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc; skips inside the test when "
        "torch.cuda.is_available() is false")
    try:
        multiprocessing.set_start_method("spawn")
    except RuntimeError:
        pass  # already set for this interpreter — keep whatever it is


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    marker = item.get_closest_marker("timeout_s")
    seconds = float(marker.args[0]) if marker else DEFAULT_TIMEOUT_S
    if seconds <= 0 or not hasattr(signal, "SIGALRM"):
        yield
        return

    def _on_timeout(signum, frame):
        raise TimeoutError(
            f"{item.nodeid} exceeded the {seconds:.0f}s watchdog "
            f"(mark with @pytest.mark.timeout_s to adjust)")

    old_handler = signal.signal(signal.SIGALRM, _on_timeout)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old_handler)
