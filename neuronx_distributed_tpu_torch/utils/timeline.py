"""Chrome-trace host timeline and device profiler hook, re-exported from
:mod:`neuronx_distributed_tpu_torch.obs.tracing` (counterpart of
``neuronx_distributed_tpu/utils/timeline.py``)."""

from neuronx_distributed_tpu_torch.obs.tracing import (  # noqa: F401
    Timeline,
    append_chrome_events,
    device_trace,
    write_chrome_trace,
)

__all__ = ["Timeline", "device_trace", "append_chrome_events",
           "write_chrome_trace"]
