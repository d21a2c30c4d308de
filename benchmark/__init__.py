"""The benchmark of the port (``smpltpu_torch``): ``python3 -m benchmark.run``."""
