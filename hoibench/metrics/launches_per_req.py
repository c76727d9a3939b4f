"""Kernel launches the host issued (``cudaLaunchKernel*``, ``cuLaunchKernel*``
rows of the trace) per traced request."""

from hoibench.trace import launches_per_unit as read  # noqa: F401
