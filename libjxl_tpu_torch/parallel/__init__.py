"""Host-side parallelism: the runner that fans a frame's sections out
over a thread pool (lib/jxl/base/data_parallel.h analogue)."""

from libjxl_tpu_torch.parallel.runner import (  # noqa: F401
    SerialRunner, ThreadRunner, get_runner, set_runner,
)

__all__ = ["SerialRunner", "ThreadRunner", "get_runner", "set_runner"]
