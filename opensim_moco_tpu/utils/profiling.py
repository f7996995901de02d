"""In-product profiling hooks (SURVEY §5: the reference ships no profiler
either, but production deployment needs one; this wraps JAX's native
device tracing instead of porting OpenSim's wall-clock timers).

* :func:`trace` — context manager around `jax.profiler.trace`: captures a
  device trace (XLA op timeline, HBM usage) viewable in
  TensorBoard/Perfetto.
* :class:`StageTimer` — lightweight named wall-clock stages with a
  printable report, used by Study.solve(profile=...) to attribute time to
  transcription build / compile+first-call / solve / post-processing.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(log_dir):
    """Capture a JAX device trace into ``log_dir`` (TensorBoard format)."""
    import jax

    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Named wall-clock stages: ``with timer.stage("solve"): ...``."""

    def __init__(self):
        self.stages = []  # (name, seconds), in order

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append((name, time.perf_counter() - t0))

    def report(self):
        total = sum(s for _, s in self.stages) or 1.0
        lines = [f"  {n:<24s} {s:8.3f}s  {100 * s / total:5.1f}%"
                 for n, s in self.stages]
        return "profile:\n" + "\n".join(lines)

    def as_dict(self):
        return dict(self.stages)
