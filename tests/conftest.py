"""Test bootstrap: make ``src`` importable and soften optional deps.

``hypothesis`` is an *optional* dev dependency (requirements-dev.txt): when
it is missing, a fixed-seed fallback implementing the subset the suite uses
is installed so all modules still collect and run.

``pytest-timeout`` is likewise optional: the concurrency lane
(tests/test_frontend.py) runs under per-test timeouts so a scheduler
deadlock fails fast instead of hanging tier-1.  When the real plugin is
absent, a minimal SIGALRM-based fallback honors ``@pytest.mark.timeout(N)``
and ``--timeout=N`` on POSIX main threads — enough to turn a deadlock into
a loud failure with a traceback.
"""

import os
import signal
import sys
import threading

import pytest

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

try:
    import hypothesis

    _USING_HYPOTHESIS_FALLBACK = getattr(hypothesis, "__is_repro_fallback__", False)
except ImportError:
    from repro.testing import hypothesis_fallback

    hypothesis_fallback.install()
    _USING_HYPOTHESIS_FALLBACK = True

try:
    import pytest_timeout  # noqa: F401  (the real plugin takes over fully)

    _HAVE_PYTEST_TIMEOUT = True
except ImportError:
    _HAVE_PYTEST_TIMEOUT = False


def pytest_report_header(config):
    lines = [
        "hypothesis: fixed-seed repro fallback (property tests run 10-20 "
        "deterministic examples)"
        if _USING_HYPOTHESIS_FALLBACK
        else "hypothesis: real package"
    ]
    if not _HAVE_PYTEST_TIMEOUT:
        lines.append(
            "pytest-timeout: SIGALRM fallback (honors @pytest.mark.timeout "
            "and --timeout)"
        )
    return lines


def pytest_addoption(parser):
    if not _HAVE_PYTEST_TIMEOUT:
        parser.addoption(
            "--timeout",
            action="store",
            default=None,
            type=float,
            help="per-test timeout in seconds (SIGALRM fallback for the "
            "absent pytest-timeout plugin)",
        )


def pytest_configure(config):
    # fast/slow split: `-m "not slow"` is the quick tier-1 lane in
    # scripts/check.sh; the multi-process mesh smokes run behind `-m slow`
    config.addinivalue_line(
        "markers",
        "slow: multi-process / virtual-device subprocess tests (run via "
        "`pytest -m slow`; excluded from the fast check.sh lane)",
    )
    config.addinivalue_line(
        "markers",
        "concurrency: deterministic scheduler / threading tests "
        "(tests/test_frontend.py); check.sh runs them as their own lane "
        "under a per-test timeout so a deadlock fails fast",
    )
    config.addinivalue_line(
        "markers",
        "chaos: seeded fault-injection tests (tests/test_faults.py); "
        "check.sh runs them as their own lane with a fixed "
        "REPRO_FAULT_SEED under a per-test timeout",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's hand-written kernels); skips "
        "without one",
    )
    if not _HAVE_PYTEST_TIMEOUT:
        config.addinivalue_line(
            "markers",
            "timeout(seconds): per-test timeout (SIGALRM fallback when "
            "pytest-timeout is not installed)",
        )


def _fallback_timeout_for(item):
    marker = item.get_closest_marker("timeout")
    if marker is not None and (marker.args or "timeout" in marker.kwargs):
        return float(marker.kwargs.get("timeout", marker.args[0] if marker.args else 0))
    opt = item.config.getoption("--timeout", default=None)
    return float(opt) if opt else None


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    # only when the real plugin is missing, on a POSIX main thread (SIGALRM
    # interrupts even a lock wait there, which is exactly the deadlock case
    # this guards)
    timeout = None
    if (
        not _HAVE_PYTEST_TIMEOUT
        and hasattr(signal, "SIGALRM")
        and threading.current_thread() is threading.main_thread()
    ):
        timeout = _fallback_timeout_for(item)
    if not timeout or timeout <= 0:
        return (yield)

    def _on_alarm(signum, frame):
        raise TimeoutError(
            f"{item.nodeid} exceeded the {timeout:g}s per-test timeout "
            f"(fallback pytest-timeout)"
        )

    previous = signal.signal(signal.SIGALRM, _on_alarm)
    signal.setitimer(signal.ITIMER_REAL, timeout)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
