"""The benchmark of ``skghoi_torch`` on an NVIDIA H100: ``python3 -m hoibench.run``."""
